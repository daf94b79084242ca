"""Stage A's language-model node embedding (counterpart of
biomedkg_tpu/data/lm_embed.py), without ``transformers``.

``NodeEmbedding(model_name_or_path, batch_size=32, device=None)`` maps a
list of texts to their CLS vectors (n, hidden) float32 numpy. The model
directory is a local path or a hub name in the Hugging Face cache
(``interop/hf_files.py``; nothing is downloaded). Its tokenizer is the
port's WordPiece (``data/wordpiece.py``), which gives
``BertTokenizerFast``'s ids; its model the port's BERT encoder
(``models/bert.py``) in float32 on ``device``: ``None`` means the card
(``device.resolve_device``, which refuses TF32), ``"cpu"`` the CPU.

Each call tokenizes with padding, truncation and ``max_length`` 512, then
pads to the JAX package's static buckets (``_call_flax``): the sequence
length up to a multiple of 128 (at most 512) and the rows up to a
multiple of ``batch_size``, pad rows holding the pad id under mask 0, so
a sweep runs at most four lengths per row count.

A model path containing "DNA" reads its ``config.json`` as a BERT config
whatever its ``model_type`` (the reference's DNABERT branch). Models that
are not BERT with a WordPiece tokenizer (MoLFormer, DNABERT-2's BPE)
raise ``NotImplementedError`` naming ROADMAP.md.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..interop.hf_files import resolve_model_dir
from ..models.bert import BertConfig, BertModel
from .wordpiece import WordPieceTokenizer

MAX_LENGTH = 512
LENGTH_BUCKET = 128


def _bucket(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


def check_model(model_name_or_path: str) -> None:
    """Read ``model_name_or_path``'s tokenizer and config as
    ``NodeEmbedding`` reads them, so that a model missing from the cache
    or not ported raises before any text is encoded."""
    directory = resolve_model_dir(model_name_or_path)
    WordPieceTokenizer.from_dir(directory)
    BertConfig.from_dir(directory, as_bert="DNA" in model_name_or_path)


class NodeEmbedding:
    def __init__(self, model_name_or_path: str, batch_size: int = 32,
                 device: Optional[Union[str, torch.device]] = None):
        self.batch_size = batch_size
        self.device = resolve_device(device)
        directory = resolve_model_dir(model_name_or_path)
        self.tokenizer = WordPieceTokenizer.from_dir(directory)
        self.model = BertModel.from_pretrained(
            directory, self.device, as_bert="DNA" in model_name_or_path)

    def tokenize(self, input_lst: List[str]) -> Dict[str, np.ndarray]:
        """The tokens of ``input_lst`` padded to the static bucket."""
        tokens = self.tokenizer(input_lst, max_length=MAX_LENGTH)
        n, length = tokens["input_ids"].shape
        width = min(_bucket(length, LENGTH_BUCKET), MAX_LENGTH)
        rows = _bucket(n, self.batch_size)
        pad_id = self.tokenizer.pad_token_id or 0
        return {k: np.pad(v, ((0, rows - n), (0, width - length)),
                          constant_values=pad_id if k == "input_ids" else 0)
                for k, v in tokens.items()}

    def encode(self, tokens: Dict[str, np.ndarray]) -> torch.Tensor:
        """The CLS rows of every bucket row, on the device."""
        args = [torch.from_numpy(tokens[k]).to(self.device)
                for k in ("input_ids", "token_type_ids", "attention_mask")]
        with torch.no_grad():
            return self.model(*args)

    def __call__(self, input_lst: List[str]) -> np.ndarray:
        cls = self.encode(self.tokenize(input_lst))
        return cls[:len(input_lst)].cpu().numpy().astype(np.float32)
