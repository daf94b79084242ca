"""Node-feature encoders (counterpart of biomedkg_tpu/data/node_encoders.py).

* ``RandomEncode``: xavier-normal (N, d) features from a seeded generator;
* ``LMMultiModalsEncode``: Stage A's cache ``data/embed/<config
  stem>_lm.pickle``, name → (2, embed_dim) rows (the two modalities' LM
  embeddings, L2-normalised over the modality axis). Its modality yaml
  (``configs/lm_modality/*.yaml``) is read by the port's config layer.
  Building the cache runs the LMs over the modality csvs, which are not
  in the repository: ``_build_cache`` raises (ROADMAP.md queue 1, item 8),
  so the cache has to be present;
* ``GCLEncode``: Stage B's cache ``data/gcl_embed/<model>_<fuse>.pickle``,
  name → (1, d) rows. When it is missing it is built from the first GCL
  checkpoint the reference's glob lists for gene, drug and disease
  (``ckpt/gcl/<type>/<model>*<fuse>*lm*/*.ckpt``): one full-graph encode
  of each type's graph over its LM features (``BIOMEDKG_MODALITY_CONFIG``
  names another modality yaml), in the "dst" layout on the device the
  caller names (the CUDA segment-sum on the card), where the reference
  ran one neighbour batch per node;
* ``KGEEncode``: Stage C's cache ``data/kge_embed/<stem>`` of a KGE
  checkpoint's full-graph encode, for the downstream models.

A cache miss takes an xavier-normal row drawn from a generator seeded by a
sha256 of the first three names (stable across processes);
``random_init_ratio`` is the share of misses of the last call. Caches are
read with an unpickler that admits numpy arrays and plain containers only.
"""

from __future__ import annotations

import glob
import hashlib
import os
import pickle
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..config import REPO_ROOT, load_yaml_file

MODALITY_CONFIG = "configs/lm_modality/primekg_modality.yaml"
_SAFE_BUILTINS = frozenset({"dict", "list", "tuple", "int", "float", "str",
                            "bytes", "bool", "complex", "set", "frozenset"})


def xavier_normal_np(rng: np.random.Generator, shape) -> np.ndarray:
    """torch.nn.init.xavier_normal_ semantics on a 2D shape."""
    fan_out, fan_in = shape[0], shape[1]
    std = np.sqrt(2.0 / (fan_in + fan_out))
    return (std * rng.standard_normal(shape)).astype(np.float32)


class _ArrayUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module.split(".")[0] == "numpy"
                or (module == "builtins" and name in _SAFE_BUILTINS)
                or (module, name) in {("collections", "OrderedDict"),
                                      ("copyreg", "_reconstructor"),
                                      ("_codecs", "encode")}):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"an embedding cache holds {module}.{name}; only numpy arrays "
            "are read")


def _resolve(path: str) -> str:
    """``path`` under the working directory, else under the repository."""
    if os.path.isabs(path) or os.path.exists(path):
        return path
    return str(REPO_ROOT / path)


class RandomEncode:
    def __init__(self, embed_dim: int = 768, seed: int = 42):
        self.embed_dim = embed_dim
        self.random_init_ratio = 1
        self._rng = np.random.default_rng(seed)

    def __call__(self, lst_node: List[str]) -> np.ndarray:
        return xavier_normal_np(self._rng, (len(lst_node), self.embed_dim))


class _PickleCacheEncode:
    """Cache lookup: a hit gives the stored rows, a miss xavier rows."""

    artifact_path: str
    embed_dim: int
    miss_shape: tuple

    def _load_mapping(self) -> Dict[str, np.ndarray]:
        if not os.path.exists(self.artifact_path):
            self._build_cache()
        with open(self.artifact_path, "rb") as f:
            return _ArrayUnpickler(f).load()

    def _build_cache(self):
        raise NotImplementedError

    def __call__(self, lst_node: List[str]) -> np.ndarray:
        digest = hashlib.sha256(
            "|".join(str(n) for n in lst_node[:3]).encode()).digest()
        rng = np.random.default_rng(int.from_bytes(digest[:4], "little"))
        rows, misses = [], 0
        for name in lst_node:
            emb = self.node_mapping.get(name)
            if emb is None:
                emb = xavier_normal_np(rng, self.miss_shape)
                misses += 1
            rows.append(np.asarray(emb, dtype=np.float32))
        self.random_init_ratio = misses / max(len(lst_node), 1)
        return np.stack(rows, axis=0)


def _write_mapping(path: str, mapping: Dict[str, np.ndarray]) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(mapping, f, protocol=pickle.HIGHEST_PROTOCOL)


class LMMultiModalsEncode(_PickleCacheEncode):
    def __init__(self, config_file: str, embed_dim: int = 768,
                 batch_size: int = 128):
        self.conf = load_yaml_file(_resolve(config_file))
        self.artifact_path = os.path.join(
            "data", "embed", f"{Path(config_file).stem}_lm.pickle")
        self.embed_dim = embed_dim
        self.batch_size = batch_size
        self.miss_shape = (2, embed_dim)
        self.node_mapping = self._load_mapping()
        self.random_init_ratio = 0

    def _build_cache(self):
        raise NotImplementedError(
            f"the LM cache {self.artifact_path} is missing, and building it "
            "(Stage A: the LMs over the modality csvs) is not ported yet "
            "(ROADMAP.md queue 1, item 8); put the cache in place")


class GCLEncode(_PickleCacheEncode):
    data_gcl = os.path.join("data", "gcl_embed")
    gcl_ckpt = os.path.join("ckpt", "gcl")

    def __init__(self, model_name: str, fuse_method: str, embed_dim: int,
                 device: Optional[str] = None):
        self.model_name = model_name
        self.fuse_method = fuse_method
        self.embed_dim = embed_dim
        self.device = device
        self.miss_shape = (1, embed_dim)
        os.makedirs(self.data_gcl, exist_ok=True)
        self.artifact_path = os.path.join(
            self.data_gcl, f"{model_name}_{fuse_method}.pickle")
        self.node_mapping = self._load_mapping()
        self.random_init_ratio = 0

    def checkpoint_of(self, node_type: str) -> str:
        """The reference's pick: the first file its glob lists."""
        pattern = (f"{self.gcl_ckpt}/{node_type}/{self.model_name}"
                   f"*{self.fuse_method}*lm*/*.ckpt")
        files = glob.glob(pattern)
        if not files:
            raise FileNotFoundError(
                f"Can't find checkpoint with pattern {pattern}")
        return files[0]

    def _build_cache(self):
        from ..device import resolve_device
        from ..sampling.batch import batch_to_device
        from ..sampling.loaders import FullGraphLoader
        from ..training.gcl_module import load_gcl_module
        from .modules import PrimeKGModule

        if not os.path.exists(self.gcl_ckpt):
            raise FileNotFoundError(
                f"Can't find checkpoints from {self.gcl_ckpt}")
        device = resolve_device(self.device)
        node_mapping: Dict[str, np.ndarray] = {}
        for node_type in ["gene", "drug", "disease"]:
            module = load_gcl_module(self.checkpoint_of(node_type), device)
            module.edge_layout = "dst"
            full_type = "gene/protein" if node_type.startswith("gene") \
                else node_type
            data = PrimeKGModule(
                data_dir="./data/primekg",
                embed_dim=module.hparams["in_dim"], node_type=[full_type],
                batch_size=128, val_ratio=0.2, test_ratio=0.2,
                node_init_method="lm",
                modality_config_path=os.environ.get(
                    "BIOMEDKG_MODALITY_CONFIG", MODALITY_CONFIG))
            data.setup(stage="encode")
            graph = data.primekg.graph
            batch = FullGraphLoader(graph, edge_layout="dst").batch()
            z = module.encode(batch_to_device(batch, device))
            z = z[:graph.num_nodes].cpu().numpy()
            for i, name in enumerate(data.primekg.node_list):
                node_mapping[name] = z[i:i + 1]
            del module, data, batch
        _write_mapping(self.artifact_path, node_mapping)


class KGEEncode(_PickleCacheEncode):
    def __init__(self, ckpt_path: str, node_init_method: str,
                 gcl_model: str, gcl_fuse_method: str, out_dim: int = 256,
                 device: Optional[str] = None):
        self.ckpt_path = ckpt_path
        self.node_init_method = node_init_method
        self.gcl_model = gcl_model
        self.gcl_fuse_method = gcl_fuse_method
        self.out_dim = out_dim
        self.embed_dim = out_dim
        self.device = device
        self.miss_shape = (1, out_dim)
        save_dir = os.path.join("data", "kge_embed")
        os.makedirs(save_dir, exist_ok=True)
        # the JAX package's stem rule: the last two path components
        # joined, only the final extension stripped
        joined = "_".join(ckpt_path.split("/")[-2:])
        stem = joined.rsplit(".", 1)[0] if "." in joined else joined
        self.artifact_path = os.path.join(save_dir, stem)
        self.node_mapping = self._load_mapping()
        self.random_init_ratio = 0

    def _build_cache(self):
        from ..device import resolve_device
        from ..sampling.batch import batch_to_device
        from ..sampling.loaders import FullGraphLoader
        from ..training.kge_module import load_kge_module
        from .modules import PrimeKGModule

        if not os.path.exists(self.ckpt_path):
            raise FileNotFoundError(self.ckpt_path)
        device = resolve_device(self.device)
        module = load_kge_module(self.ckpt_path, device)
        module.edge_layout = module.default_layout
        # the features' width the model was trained on (the JAX package
        # writes out 768, or 256 for GCL features: the same on real runs)
        data = PrimeKGModule(
            data_dir="./data/primekg", embed_dim=module.hparams["in_dim"],
            node_type=["gene/protein", "drug", "disease"], batch_size=64,
            val_ratio=0.2, test_ratio=0.2,
            node_init_method=self.node_init_method,
            gcl_model=self.gcl_model, gcl_fuse_method=self.gcl_fuse_method,
            device=self.device)
        data.setup(stage="encode")
        graph = data.primekg.graph
        batch = FullGraphLoader(graph,
                                edge_layout=module.edge_layout).batch()
        z = module.encode(batch_to_device(batch, device))
        z = z[:graph.num_nodes].cpu().numpy()
        _write_mapping(self.artifact_path,
                       {name: z[i:i + 1]
                        for i, name in enumerate(data.primekg.node_list)})
