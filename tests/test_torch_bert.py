"""The port's BERT encoder (models/bert.py) and Stage A's NodeEmbedding
(data/lm_embed.py) against the JAX package's NodeEmbedding on a tiny
random BERT written with ``save_pretrained`` (2 layers, hidden 768, 4
heads, intermediate 64), as tests/test_stage_a.py writes one: CLS rows of
ragged batches (rows below the batch size, lengths across the 128 edge, a
600-token text truncated at 512) against the flax backend, once against
the torch backend, through ``bert_from_flax`` of the flax params, through
a ``pytorch_model.bin`` with the ``bert.`` prefix and TF-era
``gamma`` / ``beta`` names, the "DNA" branch and ``gelu_new``. Tolerance
rtol = atol = 2e-4, the JAX package's own flax-against-torch tolerance
(tests/test_stage_a.py)."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from biomedkg_tpu.data.lm_embed import NodeEmbedding as JaxNodeEmbedding
from biomedkg_tpu_torch.data.lm_embed import NodeEmbedding
from biomedkg_tpu_torch.interop import hf_files
from biomedkg_tpu_torch.interop.jax_params import bert_from_flax
from biomedkg_tpu_torch.models.bert import BertConfig, BertModel

TOL = dict(rtol=2e-4, atol=2e-4)
LETTERS = [chr(c) for c in range(ord("a"), ord("z") + 1)]
UPPER = [c.upper() for c in LETTERS]
DIGITS = [str(i) for i in range(10)]
ASCII_PUNCT = [chr(c) for c in range(33, 127) if not chr(c).isalnum()]
# a WordPiece vocabulary: specials, characters (cased and not, accented,
# CJK, punctuation), continuing pieces and a few whole words
VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + ASCII_PUNCT
         + ["«", "»", "—", "¿", "。", "、", "「", "」", "…"]
         + LETTERS + UPPER + DIGITS + ["é", "ï", "å", "Å", "É", "σ", "ς",
                                       "中", "文", "蛋", "白"]
         + ["##" + c for c in LETTERS + UPPER + DIGITS + ["é", "ï"]]
         + ["protein", "kinase", "the", "of", "cell", "gene", "Protein",
            "##ase", "##in", "##ing", "receptor", "alpha", "café"])


def write_tiny_bert(d, layers=2, seed=0, hidden_act="gelu",
                    do_lower_case=True, strip_accents=None):
    """A random-weight BERT and its WordPiece tokenizer saved with
    ``save_pretrained`` (model.safetensors, tokenizer.json, vocab.txt,
    tokenizer_config.json, special_tokens_map.json)."""
    from transformers import BertConfig as HFConfig
    from transformers import BertModel as HFModel
    from transformers import BertTokenizerFast

    d = str(d)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "vocab.txt"), "w") as f:
        f.write("\n".join(VOCAB))
    BertTokenizerFast(vocab_file=os.path.join(d, "vocab.txt"),
                      do_lower_case=do_lower_case,
                      strip_accents=strip_accents).save_pretrained(d)
    torch.manual_seed(seed)
    cfg = HFConfig(vocab_size=len(VOCAB), hidden_size=768,
                   num_hidden_layers=layers, num_attention_heads=4,
                   intermediate_size=64, max_position_embeddings=512,
                   hidden_act=hidden_act)
    HFModel(cfg).save_pretrained(d, safe_serialization=True)
    return d


def words(n, rng):
    pool = ["protein", "kinase", "the", "of", "cell", "receptor", "alpha"]
    return " ".join(rng.choice(pool, size=n).tolist())


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return write_tiny_bert(tmp_path_factory.mktemp("m") / "tiny-bert")


@pytest.fixture(scope="module")
def texts():
    rng = np.random.default_rng(0)
    # one word one token: 1 + 2 around it; 125-127 words cross 128
    return ["first protein", words(125, rng), words(127, rng),
            words(600, rng), "x", "Protein Kinase, alpha-2 (PKA)."]


@pytest.fixture(scope="module")
def jax_flax(tiny):
    return JaxNodeEmbedding(tiny, batch_size=4, backend="flax")


@pytest.fixture(scope="module")
def port(tiny):
    return NodeEmbedding(tiny, batch_size=4, device="cpu")


def test_cls_rows_match_flax(port, jax_flax, texts):
    """Rows below the batch size (3 of 4), lengths on both sides of the
    128 edge, and 6 rows (8 in the bucket) with a 600-token text."""
    for batch in (texts[:3], texts):
        got, want = port(batch), jax_flax(batch)
        assert got.dtype == np.float32 and got.shape == (len(batch), 768)
        np.testing.assert_allclose(got, want, **TOL)
    bucket = port.tokenize(texts)
    assert bucket["input_ids"].shape == (8, 512)
    assert port.tokenize(texts[:2])["input_ids"].shape == (4, 128)
    assert port.tokenize(texts[:3])["input_ids"].shape == (4, 256)


def test_cls_rows_match_torch_backend(tiny, port, texts):
    want = JaxNodeEmbedding(tiny, batch_size=4, backend="torch")(texts)
    np.testing.assert_allclose(port(texts), want, **TOL)


def test_bert_from_flax(port, jax_flax, texts):
    """The flax params carried across give the same model as the
    checkpoint file, and so the flax rows."""
    state = bert_from_flax(jax_flax.model.params)
    model = BertModel.from_state_dict(port.model.config, state)
    for name, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(),
                                   port.model.state_dict()[name].numpy(),
                                   rtol=0, atol=1e-7, err_msg=name)
    tokens = port.tokenize(texts)
    args = [torch.from_numpy(tokens[k]) for k in
            ("input_ids", "token_type_ids", "attention_mask")]
    with torch.no_grad():
        got = model(*args)[:len(texts)].numpy()
    np.testing.assert_allclose(got, jax_flax(texts), **TOL)


def test_pytorch_bin_with_prefix_and_gamma_beta(tiny, port, jax_flax, texts,
                                                tmp_path):
    """A ``pytorch_model.bin`` of the same weights under
    ``bert.``-prefixed names, LayerNorm ``gamma`` / ``beta``, with
    ``cls.*`` heads, a pooler and ``position_ids`` beside them."""
    d = tmp_path / "bin-bert"
    shutil.copytree(tiny, d)
    state = hf_files.read_safetensors(str(d / hf_files.SAFETENSORS))
    os.remove(d / hf_files.SAFETENSORS)
    renamed = {}
    for key, t in state.items():
        key = key.replace("LayerNorm.weight", "LayerNorm.gamma")
        key = key.replace("LayerNorm.bias", "LayerNorm.beta")
        renamed["bert." + key] = t
    renamed["cls.predictions.bias"] = torch.zeros(len(VOCAB))
    renamed["bert.embeddings.position_ids"] = torch.arange(512)[None]
    torch.save(renamed, d / hf_files.PYTORCH_BIN)
    ne = NodeEmbedding(str(d), batch_size=4, device="cpu")
    for name, t in ne.model.state_dict().items():
        assert torch.equal(t, port.model.state_dict()[name]), name
    np.testing.assert_allclose(ne(texts), jax_flax(texts), **TOL)


def test_dna_branch(tiny, tmp_path, texts):
    """A path containing "DNA" reads config.json as a BERT config whatever
    its model_type (reference embed.py:19-26); without "DNA" that config
    is refused."""
    d = tmp_path / "DNA-tiny"
    shutil.copytree(tiny, d)
    cfg = json.loads((d / "config.json").read_text())
    cfg["model_type"] = "dnabert"
    (d / "config.json").write_text(json.dumps(cfg))
    got = NodeEmbedding(str(d), batch_size=4, device="cpu")(texts[:3])
    want = JaxNodeEmbedding(str(d), batch_size=4, backend="flax")(texts[:3])
    np.testing.assert_allclose(got, want, **TOL)
    other = tmp_path / "not-that"
    shutil.copytree(d, other)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        NodeEmbedding(str(other), device="cpu")


def test_gelu_new(tmp_path, texts):
    d = write_tiny_bert(tmp_path / "tanh-bert", layers=1, seed=3,
                        hidden_act="gelu_new")
    got = NodeEmbedding(d, batch_size=4, device="cpu")(texts[:3])
    want = JaxNodeEmbedding(d, batch_size=4, backend="flax")(texts[:3])
    np.testing.assert_allclose(got, want, **TOL)


def test_float64_module_agrees(port, texts):
    """The same module in float64 (chip_smoke.py's reference for the
    card) within float32's error."""
    tokens = port.tokenize(texts)
    args = [torch.from_numpy(tokens[k]) for k in
            ("input_ids", "token_type_ids", "attention_mask")]
    wide = BertModel.from_state_dict(port.model.config,
                                     port.model.state_dict()).double()
    with torch.no_grad():
        want = wide(*args)[:len(texts)].numpy()
    got = port(texts)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("change, match", [
    (dict(hidden_act="swish"), "hidden_act"),
    (dict(position_embedding_type="relative_key"), "absolute"),
])
def test_config_refusals(change, match):
    with pytest.raises(NotImplementedError, match=match):
        BertConfig(**change)


def test_missing_weight_raises(tiny, tmp_path):
    """A weight the BERT layout names but the checkpoint lacks raises,
    naming it (HF would draw it at random)."""
    d = tmp_path / "holed"
    shutil.copytree(tiny, d)
    state = hf_files.read_safetensors(str(d / hf_files.SAFETENSORS))
    del state["encoder.layer.1.output.dense.bias"]
    os.remove(d / hf_files.SAFETENSORS)
    torch.save(state, d / hf_files.PYTORCH_BIN)
    with pytest.raises(ValueError,
                       match=r"encoder\.layer\.1\.output\.dense\.bias"):
        NodeEmbedding(str(d), device="cpu")


def test_remote_code_and_other_models_raise(tiny, tmp_path):
    """MoLFormer-style configs (another model_type, an auto_map of remote
    code) raise naming ROADMAP.md."""
    for name, change in (("molformer", dict(model_type="molformer")),
                         ("auto-map", dict(auto_map={
                             "AutoModel": "modeling.MolformerModel"}))):
        d = tmp_path / name
        shutil.copytree(tiny, d)
        cfg = json.loads((d / "config.json").read_text())
        cfg.update(change)
        (d / "config.json").write_text(json.dumps(cfg))
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            NodeEmbedding(str(d), device="cpu")
