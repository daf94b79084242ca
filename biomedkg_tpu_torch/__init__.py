"""biomedkg_tpu_torch: the PyTorch / CUDA (NVIDIA H100) port of biomedkg_tpu.

The JAX package ``biomedkg_tpu`` stays the reference; this package is its
counterpart module by module (same file names) and imports neither JAX nor
anything of ``biomedkg_tpu``. Host-side data code is numpy only (no pandas,
no PyYAML); device code is torch, with the TPU's Pallas kernels replaced by
hand-written CUDA kernels under ``csrc/`` that build at first use.

Entry points take ``device=None``, which means ``"cuda"``, and raise when
CUDA is missing unless the caller passes ``device="cpu"`` (device.py).

Ported so far: the KGE serving path (``serving.KGEScorer``, ``serve.py``)
with an RGCN or RGAT encoder aggregating through the CUDA sorted
segment-sum (``ops/segsum.py``, ``csrc/segsum.cu``) or grouped GEMM
(``ops/relmm.py``, ``csrc/relmm.cu``) and four decoders; the KGE training
step (``train_kge.py``, ``training/``) on GraphSAINT batches
(``sampling/``), scoring its negatives through the CUDA negative-scoring
kernels (``ops/negscore.py``, ``csrc/negscore.cu``); and Stage B's GCL
pretraining (``train_gcl.py``, ``training/gcl_module.py``,
``models/gcl.py``) on neighbour batches, GRACE's InfoNCE denominator
through the CUDA flash kernels (``ops/flashnce.py``, ``csrc/flashnce.cu``);
the Trainer with held-out evaluation (``training/trainer.py``); filtered
ranking (``eval/ranking.py``, ``rank_eval.py``), ``test_kge.py`` and the
unseen-node protocol (``data/inductive.py``, ``eval/inductive.py``,
cold-start dropout); the config layer (``config.py``: ``configs/`` and
the scripts' override vocabulary, without PyYAML), modality fusion
(``models/fusion.py``) and the LM, GCL and KGE embedding caches
(``data/node_encoders.py``).
"""
