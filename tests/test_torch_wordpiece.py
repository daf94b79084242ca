"""The port's WordPiece tokenizer (data/wordpiece.py) against the
tokenizer the JAX package's Stage A uses (``AutoTokenizer.from_pretrained
(d, trust_remote_code=True)``, data/lm_embed.py, a ``BertTokenizerFast``):
``input_ids``, ``token_type_ids`` and ``attention_mask`` exactly equal,
called as the JAX package calls it (padding, truncation, ``max_length``
512), for both directory layouts (with ``tokenizer.json``; only
``vocab.txt`` + ``tokenizer_config.json``), lower-cased and cased, with
``strip_accents`` None, True and False, on CJK, Unicode punctuation,
control characters, ``\\t\\r\\n``, special tokens in the text, a word
past 100 characters, the empty string, truncation at 512 and at 16, and
hypothesis texts drawn from those classes. The port's character classes
and lowercasing are held to the fast tokenizer's on every code point;
the refusals (BPE, other classes, remote code, left padding or
truncation, another post-processor, normalised added tokens, a hub name
missing from the cache) and the hub-cache lookup."""

import json
import os
import shutil
import unicodedata

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from tokenizers.normalizers import BertNormalizer as FastNormalizer
from tokenizers.pre_tokenizers import BertPreTokenizer
from transformers import AutoTokenizer, BertTokenizerFast

from biomedkg_tpu.data.lm_embed import NodeEmbedding as JaxNodeEmbedding
from biomedkg_tpu_torch.data import wordpiece
from biomedkg_tpu_torch.data.wordpiece import WordPieceTokenizer
from biomedkg_tpu_torch.interop.hf_files import resolve_model_dir
from test_torch_bert import VOCAB, write_tiny_bert

KEYS = ("input_ids", "token_type_ids", "attention_mask")
LONG_WORD = "acdefghiklmnpqrstvwy" * 6           # 120 letters, no spaces
TEXTS = [
    "Protein kinase C, alpha (PRKCA) phosphorylates the receptor.",
    "CAFÉ naïve Ågström École résumé",
    "中文蛋白 mixed 中a文 一二",
    "«quoted» — dash… ¿what? 「bracket」 a、b。",
    "tab\there\nnew\rline\x00nul\x07bell\u200bzw\ufeffbom\ue000pua\ufffd",
    "nbsp\xa0ideo\u3000graphic\x85nel\x1cfs",
    "[MASK] in [CLS]text[SEP] and [UNK] [PAD]",
    "ΟΔΟΣ Σ σς İstanbul ß Æ",
    "e\u0301 combining a\u0308 and \u1734 marks",
    LONG_WORD, "x" * 100, "x" * 101, "",
    "the of the cell gene kinase receptor alpha 1234 +-*/",
]


def write_tokenizer(d, do_lower_case=True, strip_accents=None,
                    tokenizer_json=True):
    """The tokenizer files ``save_pretrained`` writes; without
    ``tokenizer_json`` only vocab.txt and tokenizer_config.json."""
    d = str(d)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "vocab.txt"), "w") as f:
        f.write("\n".join(VOCAB))
    BertTokenizerFast(vocab_file=os.path.join(d, "vocab.txt"),
                      do_lower_case=do_lower_case,
                      strip_accents=strip_accents).save_pretrained(d)
    if not tokenizer_json:
        os.remove(os.path.join(d, "tokenizer.json"))
        os.remove(os.path.join(d, "special_tokens_map.json"))
    return d


def reference(d):
    return AutoTokenizer.from_pretrained(d, trust_remote_code=True)


def assert_same(port, ref, texts, max_length=512):
    want = ref(texts, return_tensors="np", padding=True, truncation=True,
               max_length=max_length)
    got = port(texts, max_length=max_length)
    for key in KEYS:
        assert got[key].dtype == np.int64, key
        np.testing.assert_array_equal(got[key], want[key],
                                      err_msg=f"{key} of {texts!r}")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return write_tiny_bert(tmp_path_factory.mktemp("m") / "tiny-bert")


def test_node_embedding_tokenizer(tiny):
    """The JAX NodeEmbedding's own tokenizer object."""
    ref = JaxNodeEmbedding(tiny, backend="torch").tokenizer
    port = WordPieceTokenizer.from_dir(tiny)
    assert port.pad_token_id == ref.pad_token_id
    for text in TEXTS:
        assert_same(port, ref, [text])
    assert_same(port, ref, TEXTS)


@pytest.mark.parametrize("tokenizer_json", [True, False])
@pytest.mark.parametrize("lower, strip", [(True, None), (False, None),
                                          (True, False), (True, True),
                                          (False, True)])
def test_layouts_and_settings(tmp_path, tokenizer_json, lower, strip):
    d = write_tokenizer(tmp_path / "tok", lower, strip, tokenizer_json)
    port, ref = WordPieceTokenizer.from_dir(d), reference(d)
    for text in TEXTS:
        assert_same(port, ref, [text])
    assert_same(port, ref, TEXTS)


def test_tokenizer_config_overrides_tokenizer_json(tmp_path):
    """BertTokenizerFast resets the normaliser to tokenizer_config.json's
    settings (do_lower_case True when it is absent)."""
    d = write_tokenizer(tmp_path / "tok", do_lower_case=False)
    path = os.path.join(d, "tokenizer_config.json")
    cfg = json.load(open(path))
    del cfg["do_lower_case"]
    json.dump(cfg, open(path, "w"))
    port, ref = WordPieceTokenizer.from_dir(d), reference(d)
    assert port.normalizer.lowercase
    assert_same(port, ref, TEXTS)


def _edit_json(path, change):
    data = json.load(open(path))
    change(data)
    json.dump(data, open(path, "w"))


def _set(key, value):
    return lambda data: data.__setitem__(key, value)


def _normalize_added(entries):
    for entry in entries:
        entry["normalized"] = True


# (file, edit, keep tokenizer.json, what the refusal names)
UNPORTED = {
    "generic-fast-class": ("tokenizer_config.json",
                           _set("tokenizer_class", "PreTrainedTokenizerFast"),
                           True, "PreTrainedTokenizerFast"),
    "left-padding": ("tokenizer_config.json", _set("padding_side", "left"),
                     True, "padding_side 'left'"),
    "left-truncation": ("tokenizer_config.json",
                        _set("truncation_side", "left"), False,
                        "truncation_side 'left'"),
    "bert-processing": ("tokenizer.json",
                        _set("post_processor", {
                            "type": "BertProcessing", "sep": ["[SEP]", 3],
                            "cls": ["[CLS]", 2]}), True, "BertProcessing"),
    "normalized-added-json": ("tokenizer.json",
                              lambda tj: _normalize_added(tj["added_tokens"]),
                              True, "normalized"),
    "normalized-added-config": ("tokenizer_config.json",
                                lambda cfg: _normalize_added(
                                    cfg["added_tokens_decoder"].values()),
                                False, "normalized"),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_generic_fast_class_and_other_settings_raise(tmp_path, case):
    """Only ``BertTokenizer`` / ``BertTokenizerFast`` with right padding
    and truncation, the ``[CLS] $A [SEP]`` template and added tokens split
    from the raw text are read; the generic fast class, left padding or
    truncation, another post-processor and normalised added tokens raise
    naming ROADMAP.md rather than tokenize otherwise than the
    reference."""
    name, change, tokenizer_json, match = UNPORTED[case]
    d = write_tokenizer(tmp_path / "tok", tokenizer_json=tokenizer_json)
    _edit_json(os.path.join(d, name), change)
    with pytest.raises(NotImplementedError,
                       match=match + r".*ROADMAP\.md"):
        WordPieceTokenizer.from_dir(d)


@pytest.mark.parametrize("tokenizer_json", [True, False])
def test_no_pad_token_refuses_to_pad(tmp_path, tokenizer_json):
    """Without a pad token both tokenizers refuse to pad."""
    d = write_tokenizer(tmp_path / "tok", tokenizer_json=tokenizer_json)
    _edit_json(os.path.join(d, "tokenizer_config.json"),
               _set("pad_token", None))
    port, ref = WordPieceTokenizer.from_dir(d), reference(d)
    assert port.pad_token_id is None
    with pytest.raises(ValueError, match="pad"):
        ref(TEXTS, padding=True, truncation=True, max_length=512)
    with pytest.raises(ValueError, match="pad"):
        port(TEXTS)


def test_truncation(tiny):
    rng = np.random.default_rng(0)
    pool = ["protein", "kinase", "the", "of", "cell", "receptor", "alpha",
            "éa", "中"]
    texts = [" ".join(rng.choice(pool, size=n).tolist())
             for n in (3, 509, 510, 511, 600)]
    port, ref = WordPieceTokenizer.from_dir(tiny), reference(tiny)
    assert_same(port, ref, texts)
    assert port(texts)["input_ids"].shape == (5, 512)
    assert_same(port, ref, texts, max_length=16)
    assert_same(port, ref, [LONG_WORD + " a"] * 2, max_length=3)


def test_long_words_are_one_unk(tiny):
    """A word past 100 code points is one [UNK], as in the reference (an
    unspaced protein sequence included); one of exactly 100 is split."""
    port = WordPieceTokenizer.from_dir(tiny)
    unk = VOCAB.index("[UNK]")
    assert port.encode(LONG_WORD) == [unk]
    assert port.encode("é" * 101) == [unk]
    assert len(port.encode("x" * 100)) == 100
    assert port.encode("") == []


# -- the character classes on every code point -------------------------------

def _fast(**kw):
    base = dict(clean_text=False, handle_chinese_chars=False,
                strip_accents=False, lowercase=False)
    return FastNormalizer(**dict(base, **kw))


def _each(fn, texts, sep="|", chunk=4096):
    """``fn`` of each of ``texts`` alone, through one call a chunk joined
    by ``sep`` (which every normaliser keeps and the pre-tokenizer splits
    off on its own)."""
    out = []
    for i in range(0, len(texts), chunk):
        part = texts[i:i + chunk]
        got = fn(sep.join(part))
        if isinstance(got, str):
            pieces = got.split(sep)
        else:                             # pre-tokenized words
            pieces, word = [], []
            for w in got + [sep]:
                if w == sep:
                    pieces.append(word)
                    word = []
                else:
                    word.append(w)
        assert len(pieces) == len(part)
        out += pieces
    return out


def test_character_classes_match_the_fast_tokenizer():
    """clean_text, the CJK padding, accent stripping, lowercasing and the
    punctuation split, one code point at a time (the ASCII ones through
    the port's ASCII path too), against ``tokenizers``' own normaliser
    and pre-tokenizer. Where Python's Unicode tables and the fast
    tokenizer's differ the port's tables follow the fast one (e.g.
    U+2E4F, punctuation since Unicode 11, is not split off; U+1734, now a
    spacing mark, is stripped; U+A7CB lowercases to U+0264)."""
    pre = BertPreTokenizer()
    chars = [chr(cp) for cp in range(0x110000)
             if not 0xD800 <= cp <= 0xDFFF and cp != ord("|")]
    pairs = ["a" + c + "b" for c in chars]
    checks = [(name, _fast(**{name: True}),
               wordpiece.BertNormalizer(**{**dict.fromkeys(
                   ("clean_text", "handle_chinese_chars", "strip_accents",
                    "lowercase"), False), name: True}))
              for name in ("clean_text", "handle_chinese_chars",
                           "strip_accents", "lowercase")]
    bad = []
    for name, fast, port in checks:
        want = _each(fast.normalize_str, chars)
        got = _each(port, chars)
        bad += [(name, hex(ord(c))) for c, w, g in zip(chars, want, got)
                if w != g]
        bad += [(name, c) for c in map(chr, range(128))
                if fast.normalize_str(c) != port(c)]
    want = _each(lambda t: [w for w, _ in pre.pre_tokenize_str(t)], pairs)
    got = _each(wordpiece.pre_tokenize, pairs)
    bad += [("pre-tokenize", hex(ord(c))) for c, w, g in
            zip(chars, want, got) if w != g]
    bad += [("pre-tokenize", c) for c in ("|", *map(chr, range(128)))
            if [w for w, _ in pre.pre_tokenize_str("a" + c + "b")]
            != wordpiece.pre_tokenize("a" + c + "b")]
    assert not bad, bad[:20]
    assert unicodedata.unidata_version == "15.0.0"


# -- hypothesis over the classes ----------------------------------------------

CHARS = (list("abcxyzABCXYZ0129 \t\n\r") + [chr(c) for c in range(33, 48)]
         + list("\x00\x07\x1b\x7f\x85\u200b\ufeff\ufffd\xa0\u3000\ue000")
         + list("中文蛋白一龥") + list("éïåÅÉ") + ["\u0301", "\u0308"]
         + list("ΣσςİßÆ") + list("«»—¿。、「」…"))
FRAGMENTS = VOCAB[5:] + ["[MASK]", "[CLS]", "[SEP]", "[UNK]", "[PAD]",
                         "[MASK", LONG_WORD, "x" * 101]
TEXT = st.lists(st.one_of(st.text(alphabet=st.sampled_from(CHARS),
                                  max_size=12),
                          st.sampled_from(FRAGMENTS)),
                max_size=10).map("".join)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    out = {}
    for lower, strip in ((True, None), (False, False)):
        d = write_tokenizer(tmp_path_factory.mktemp("h"), lower, strip)
        out[lower] = (WordPieceTokenizer.from_dir(d), reference(d))
    return out


@given(texts=st.lists(TEXT, min_size=1, max_size=4), lower=st.booleans(),
       max_length=st.sampled_from([512, 8]))
@settings(max_examples=150, deadline=None, database=None)
def test_hypothesis_texts(both, texts, lower, max_length):
    port, ref = both[lower]
    assert_same(port, ref, texts, max_length)


# -- refusals and the hub cache ---------------------------------------------

def test_bpe_and_other_tokenizers_raise(tmp_path):
    """DNABERT-2's BPE tokenizer.json, another tokenizer class and a
    remote-code tokenizer raise naming ROADMAP.md."""
    d = write_tokenizer(tmp_path / "bpe")
    path = os.path.join(d, "tokenizer.json")
    tj = json.load(open(path))
    tj["model"] = {"type": "BPE", "vocab": tj["model"]["vocab"],
                   "merges": []}
    json.dump(tj, open(path, "w"))
    with pytest.raises(NotImplementedError, match=r"BPE.*ROADMAP\.md"):
        WordPieceTokenizer.from_dir(d)
    for change in (dict(tokenizer_class="RobertaTokenizer"),
                   dict(auto_map={"AutoTokenizer": ["tok.MolTokenizer",
                                                    None]})):
        other = tmp_path / f"other{len(os.listdir(tmp_path))}"
        shutil.copytree(write_tokenizer(tmp_path / "plain"), other)
        cfg = json.load(open(other / "tokenizer_config.json"))
        cfg.update(change)
        json.dump(cfg, open(other / "tokenizer_config.json", "w"))
        with pytest.raises(NotImplementedError, match=r"ROADMAP\.md"):
            WordPieceTokenizer.from_dir(str(other))


def test_hub_cache_lookup(tmp_path, monkeypatch):
    """A hub name resolves in the Hugging Face cache layout, as
    ``from_pretrained`` finds it there; a missing one raises."""
    hub = tmp_path / "hf" / "hub"
    repo = hub / "models--org--tiny-tok"
    (repo / "refs").mkdir(parents=True)
    (repo / "refs" / "main").write_text("0123abc")
    snapshot = write_tokenizer(repo / "snapshots" / "0123abc")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    assert resolve_model_dir("org/tiny-tok") == snapshot
    port = WordPieceTokenizer.from_dir(resolve_model_dir("org/tiny-tok"))
    ref = AutoTokenizer.from_pretrained("org/tiny-tok", cache_dir=str(hub),
                                        local_files_only=True)
    assert_same(port, ref, TEXTS)
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        resolve_model_dir("dmis-lab/biobert-v1.1")
