"""Hugging Face checkpoint directories, read without ``transformers``,
``tokenizers`` or ``safetensors``.

* ``resolve_model_dir``: a local directory is used as given; a hub name
  (``dmis-lab/biobert-v1.1``) is looked up in the Hugging Face cache
  (``$HF_HUB_CACHE``, else ``$HF_HOME/hub``, else
  ``~/.cache/huggingface/hub``) at ``models--<org>--<name>/snapshots/<the
  commit refs/main names>/``. Nothing is downloaded: a name missing from
  the cache raises ``FileNotFoundError``.
* ``read_safetensors``: the safetensors format (an 8-byte little-endian
  header length, a JSON header ``{name: {dtype, shape, data_offsets}}``
  with an optional ``__metadata__``, then the raw little-endian bytes)
  parsed here, tensors made with ``torch.frombuffer``; F32, F16, BF16,
  F64 and I64 are read, another dtype raises.
* ``load_state_dict``: ``model.safetensors`` when present (as
  ``from_pretrained`` prefers it), else ``pytorch_model.bin`` through
  ``torch.load(weights_only=True)``, with the keys normalised as
  ``from_pretrained`` normalises them for a base model: the base-model
  prefix (``bert.``) stripped and the TF-era LayerNorm names
  ``gamma`` / ``beta`` read as ``weight`` / ``bias``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict

import torch

SAFETENSORS = "model.safetensors"
PYTORCH_BIN = "pytorch_model.bin"
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64}


def hub_cache_dir() -> str:
    cache = os.environ.get("HF_HUB_CACHE")
    if cache:
        return cache
    home = os.environ.get("HF_HOME") or os.path.join(
        os.environ.get("XDG_CACHE_HOME")
        or os.path.join(os.path.expanduser("~"), ".cache"), "huggingface")
    return os.path.join(home, "hub")


def resolve_model_dir(name_or_path: str) -> str:
    """The directory holding ``name_or_path``'s files."""
    if os.path.isdir(name_or_path):
        return name_or_path
    repo = os.path.join(hub_cache_dir(),
                        "models--" + name_or_path.replace("/", "--"))
    ref = os.path.join(repo, "refs", "main")
    if os.path.isfile(ref):
        with open(ref) as f:
            snapshot = os.path.join(repo, "snapshots", f.read().strip())
        if os.path.isdir(snapshot):
            return snapshot
    raise FileNotFoundError(
        f"{name_or_path!r} is not a directory and not in the Hugging Face "
        f"cache ({repo}); the port downloads nothing: pass a local "
        "checkpoint directory or put the model in that cache")


def read_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if len(data) < 8:
        raise ValueError(f"{path}: not a safetensors file")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path}: header length {n} past the file's end")
    header = json.loads(data[8:8 + n].decode("utf-8"))
    header.pop("__metadata__", None)
    base = 8 + n
    out = {}
    for name, entry in header.items():
        dtype = SAFETENSORS_DTYPES.get(entry["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {entry['dtype']}, "
                             "which this reader does not take")
        start, end = entry["data_offsets"]
        shape = [int(s) for s in entry["shape"]]
        numel = 1
        for s in shape:
            numel *= s
        if end - start != numel * dtype.itemsize or base + end > len(data):
            raise ValueError(f"{path}: {name}'s offsets {start}:{end} do "
                             f"not hold {shape} {entry['dtype']}")
        raw = torch.frombuffer(data, dtype=torch.uint8, count=end - start,
                               offset=base + start) if end > start \
            else torch.zeros(0, dtype=torch.uint8)
        # the copy is aligned for its type, and owns its memory
        out[name] = raw.clone().view(dtype).reshape(shape)
    return out


def normalise_keys(state: Dict[str, torch.Tensor],
                   prefix: str) -> Dict[str, torch.Tensor]:
    """``state`` under the base model's own names: ``prefix`` stripped
    from the keys that have it, ``gamma`` / ``beta`` renamed."""
    out = {}
    for key, value in state.items():
        if key.startswith(prefix):
            key = key[len(prefix):]
        parts = key.split(".")
        if parts[-1] == "gamma":
            parts[-1] = "weight"
        elif parts[-1] == "beta":
            parts[-1] = "bias"
        out[".".join(parts)] = value
    return out


def load_state_dict(directory: str, prefix: str) -> Dict[str, torch.Tensor]:
    """The checkpoint's tensors under normalised names (see the module
    docstring), on the CPU in their stored types."""
    path = os.path.join(directory, SAFETENSORS)
    if os.path.isfile(path):
        state = read_safetensors(path)
    else:
        path = os.path.join(directory, PYTORCH_BIN)
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"{directory} holds neither {SAFETENSORS} nor {PYTORCH_BIN}")
        state = torch.load(path, map_location="cpu", weights_only=True)
    return normalise_keys(state, prefix)
