"""The BERT encoder of Stage A as an ``nn.Module``, built from a checkpoint
directory's ``config.json`` and weights without ``transformers``.

The JAX package runs HF's ``FlaxBertModel`` (``data/lm_embed.py``); the
port computes the same function in plain float32 PyTorch, with the Flax
model's arithmetic: word + position + token-type embeddings and a
LayerNorm; then per layer q, k, v, the scores of q / sqrt(head dim)
against k plus the additive mask ``(1 - mask) · finfo.min``, a softmax,
the context, the output dense with residual and LayerNorm, the
intermediate dense with its activation, the output dense with residual
and LayerNorm. Inference only: no dropout, no pooler. ``forward`` returns
``last_hidden_state[:, 0]``, the CLS vector Stage A keeps.

The parameters carry HF's names (``embeddings.word_embeddings.weight``,
``encoder.layer.<i>.attention.self.query.weight``, ...), so a
checkpoint's tensors load by name once ``interop/hf_files.py`` has
normalised them. A weight the layout names but the checkpoint lacks
raises: HF and Flax would draw it at random, which nothing can match.

Ported: ``model_type`` bert with absolute position embeddings and
``hidden_act`` gelu (erf), gelu_new / gelu_pytorch_tanh (tanh) or relu.
A ``config.json`` of another type, or with an ``auto_map`` (remote code,
such as MoLFormer), raises ``NotImplementedError``; ``as_bert=True`` reads
any ``config.json`` as a BERT config, as the JAX package does for a model
path containing "DNA".
"""

from __future__ import annotations

import math
import os
from typing import Dict, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..interop.hf_files import load_state_dict, read_json

NOT_PORTED = ("only BERT encoders are ported (ROADMAP.md queue 1, item 8's "
              "remainder: MoLFormer's and DNABERT-2's encoders wait for "
              "their files in the repository)")
ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}
# BertConfig's defaults for the keys a config.json may leave out
DEFAULTS = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                num_attention_heads=12, intermediate_size=3072,
                hidden_act="gelu", max_position_embeddings=512,
                type_vocab_size=2, layer_norm_eps=1e-12,
                position_embedding_type="absolute")


class BertConfig:
    def __init__(self, **values):
        merged = dict(DEFAULTS, **values)
        for key in DEFAULTS:
            setattr(self, key, merged[key])
        if self.hidden_act not in ACTIVATIONS:
            raise NotImplementedError(
                f"hidden_act {self.hidden_act!r}; ported: "
                f"{sorted(ACTIVATIONS)}")
        if self.position_embedding_type != "absolute":
            raise NotImplementedError(
                f"position_embedding_type {self.position_embedding_type!r}; "
                "only absolute is ported")
        if self.hidden_size % self.num_attention_heads:
            raise ValueError(f"hidden_size {self.hidden_size} is not a "
                             f"multiple of {self.num_attention_heads} heads")

    @classmethod
    def from_dir(cls, directory: str, as_bert: bool = False) -> "BertConfig":
        values = read_json(os.path.join(directory, "config.json"))
        if not as_bert:
            if "auto_map" in values:
                raise NotImplementedError(
                    f"{directory}: a remote-code model ({values['auto_map']}"
                    "); " + NOT_PORTED)
            if values.get("model_type") != "bert":
                raise NotImplementedError(
                    f"{directory}: model_type {values.get('model_type')!r}; "
                    + NOT_PORTED)
        return cls(**{k: v for k, v in values.items() if k in DEFAULTS})


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, d)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, d)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, d)
        self.LayerNorm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)

    def forward(self, input_ids, token_type_ids):
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(positions)[None]
             + self.token_type_embeddings(token_type_ids))
        return self.LayerNorm(x)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)

    def forward(self, x, bias):
        b, n, d = x.shape
        dh = d // self.heads

        def heads(t):
            return t.view(b, n, self.heads, dh).transpose(1, 2)

        # as flax's dot_product_attention_weights: q scaled first
        q = heads(self.query(x)) / math.sqrt(dh)
        scores = torch.matmul(q, heads(self.key(x)).transpose(-1, -2)) + bias
        weights = torch.softmax(scores, dim=-1)
        context = torch.matmul(weights, heads(self.value(x)))
        return context.transpose(1, 2).reshape(b, n, d)


class BertSelfOutput(nn.Module):
    def __init__(self, cfg: BertConfig, d_in: int):
        super().__init__()
        self.dense = nn.Linear(d_in, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, h, residual):
        return self.LayerNorm(self.dense(h) + residual)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertSelfOutput(cfg, cfg.hidden_size)

    def forward(self, x, bias):
        return self.output(self.self(x, bias), x)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.act = ACTIVATIONS[cfg.hidden_act]

    def forward(self, x):
        return self.act(self.dense(x))


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertSelfOutput(cfg, cfg.intermediate_size)

    def forward(self, x, bias):
        x = self.attention(x, bias)
        return self.output(self.intermediate(x), x)


class BertEncoderStack(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg)
                                   for _ in range(cfg.num_hidden_layers))

    def forward(self, x, bias):
        for layer in self.layer:
            x = layer(x, bias)
        return x


class BertModel(nn.Module):
    """``(input_ids, token_type_ids, attention_mask)`` (B, L) → the CLS
    rows (B, hidden) of the last hidden state."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoderStack(cfg)

    def forward(self, input_ids, token_type_ids, attention_mask):
        x = self.embeddings(input_ids, token_type_ids)
        # HF's extended mask: 0 where attended, the type's minimum where not
        keep = attention_mask[:, None, None, :].to(x.dtype)
        bias = (1.0 - keep) * torch.finfo(x.dtype).min
        return self.encoder(x, bias)[:, 0]

    @classmethod
    def from_state_dict(cls, cfg: BertConfig,
                        state: Dict[str, torch.Tensor],
                        device: Union[str, torch.device] = "cpu",
                        where: str = "the checkpoint") -> "BertModel":
        """The model with ``state``'s tensors (HF names; extra keys such as
        ``pooler.*``, ``cls.*`` or ``embeddings.position_ids`` are not
        read) in float32 on ``device``."""
        with torch.device("meta"):
            model = cls(cfg)
        wanted = model.state_dict()
        missing = sorted(k for k in wanted if k not in state)
        if missing:
            raise ValueError(f"{where} lacks {len(missing)} weights of the "
                             f"BERT layout: {missing[:8]}")
        tensors = {}
        for key, meta in wanted.items():
            t = state[key]
            if tuple(t.shape) != tuple(meta.shape):
                raise ValueError(f"{where}: {key} has shape "
                                 f"{tuple(t.shape)}, the config gives "
                                 f"{tuple(meta.shape)}")
            tensors[key] = t.to(device=device, dtype=torch.float32)
        model.load_state_dict(tensors, assign=True)
        return model.eval()

    @classmethod
    def from_pretrained(cls, directory: str,
                        device: Union[str, torch.device] = "cpu",
                        as_bert: bool = False) -> "BertModel":
        cfg = BertConfig.from_dir(directory, as_bert=as_bert)
        return cls.from_state_dict(cfg, load_state_dict(directory, "bert."),
                                   device, where=directory)

