"""The WordPiece tokenizer that ``AutoTokenizer`` gives for a BERT
checkpoint directory (``BertTokenizerFast``), without ``transformers`` or
``tokenizers``.

``WordPieceTokenizer.from_dir(d)`` reads ``d`` as ``from_pretrained``
does. With ``tokenizer.json`` it takes that file's ``BertNormalizer``,
``BertPreTokenizer``, ``WordPiece`` model (vocabulary, ``unk_token``,
``continuing_subword_prefix``, ``max_input_chars_per_word``), added tokens
and ``[CLS] $A [SEP]`` template; the normaliser's ``lowercase`` /
``strip_accents`` / ``handle_chinese_chars`` are then
``tokenizer_config.json``'s ``do_lower_case`` / ``strip_accents`` /
``tokenize_chinese_chars``, defaults True / None / True, as
``BertTokenizerFast.__init__`` resets them. Without it, ``vocab.txt``
(one token a line, the line number its id) with those settings, as the
slow-to-fast converter builds it. Only a ``BertTokenizer`` /
``BertTokenizerFast`` class (or none, with a bert ``config.json``) with
right padding and truncation is read. Anything else raises
``NotImplementedError``: a tokenizer that is not WordPiece (a BPE
``tokenizer.json`` such as DNABERT-2's), another tokenizer class, remote
code, another post-processor, left padding or truncation, and added
tokens that are normalised or strip their neighbours.

``tokenizer(texts, max_length=512)`` is ``tokenizer(texts, padding=True,
truncation=True, max_length=512)``: ``input_ids``, ``token_type_ids`` and
``attention_mask`` as int64 numpy arrays, each text truncated to
``max_length - 2`` pieces between ``[CLS]`` and ``[SEP]`` and padded to
the batch's longest row with the pad id (type 0, mask 0).

A text goes through the fast tokenizer's steps in its order: added tokens
(the special tokens) are split out of the raw text, leftmost-longest;
then each remaining piece is normalised (``clean_text``: NUL, U+FFFD and
control / format / private-use characters dropped, ``\\t\\n\\r`` and the
other White_Space characters made spaces; CJK ideographs padded with
spaces; accents stripped by NFD and dropping non-spacing marks, which by
default follows ``lowercase``; then lowercased one character at a time,
so no final-sigma rule); split on whitespace and around every punctuation
character (ASCII 33-47, 58-64, 91-96, 123-126 and Unicode ``P*``); and
each word is matched greedily, longest prefix first, against the
vocabulary, continuing pieces with ``##``. A word longer than
``max_input_chars_per_word`` code points, or with any piece missing, is
one ``[UNK]``: an unspaced protein sequence past 100 letters is one
``[UNK]`` in the reference too.

The fast tokenizer's character classes come from older Unicode tables
than Python's ``unicodedata`` (15.0 in Python 3.12), and its lowercasing
from a newer one. The tables below list the code points where the two
disagree, so that the port follows the fast tokenizer on every one of
them (tests/test_torch_wordpiece.py holds them against ``tokenizers``
over all of Unicode).
"""

from __future__ import annotations

import os
import re
import unicodedata
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..interop.hf_files import read_json

NOT_PORTED = ("only BERT WordPiece tokenizers are ported (ROADMAP.md queue "
              "1, item 8's remainder: MoLFormer's and DNABERT-2's "
              "tokenizers wait for their files in the repository)")
SEE_ROADMAP = "(ROADMAP.md queue 1, item 8's remainder)"
BERT_CLASSES = ("BertTokenizer", "BertTokenizerFast")
SPECIAL_KEYS = ("unk_token", "sep_token", "pad_token", "cls_token",
                "mask_token")
DEFAULT_SPECIALS = {"unk_token": "[UNK]", "sep_token": "[SEP]",
                    "pad_token": "[PAD]", "cls_token": "[CLS]",
                    "mask_token": "[MASK]"}

# the Unicode White_Space property (Rust's char::is_whitespace)
WHITESPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680"
    + "".join(map(chr, range(0x2000, 0x200B)))
    + "\u2028\u2029\u202f\u205f\u3000")
# the CJK blocks the fast tokenizer pads with spaces (its own list: it has
# 0x2B920 where BERT's original code has 0x2B820)
CJK_RANGES = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
              (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF),
              (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))
# format characters newer than the fast tokenizer's tables: kept
NOT_CONTROL = ((0x890, 0x891), (0x8E2, 0x8E2), (0x110CD, 0x110CD),
               (0x13430, 0x1343F))
# punctuation newer than its tables: not split off
NOT_PUNCT = (
    (0x61D, 0x61D), (0x9FD, 0x9FD), (0xA76, 0xA76), (0xC77, 0xC77),
    (0xC84, 0xC84), (0x1B7D, 0x1B7E), (0x2E43, 0x2E4F), (0x2E52, 0x2E5D),
    (0x10EAD, 0x10EAD), (0x10F55, 0x10F59), (0x10F86, 0x10F89),
    (0x1144B, 0x1144F), (0x1145A, 0x1145B), (0x1145D, 0x1145D),
    (0x11660, 0x1166C), (0x116B9, 0x116B9), (0x1183B, 0x1183B),
    (0x11944, 0x11946), (0x119E2, 0x119E2), (0x11A3F, 0x11A46),
    (0x11A9A, 0x11A9C), (0x11A9E, 0x11AA2), (0x11B00, 0x11B09),
    (0x11C41, 0x11C45), (0x11C70, 0x11C71), (0x11EF7, 0x11EF8),
    (0x11F43, 0x11F4F), (0x11FFF, 0x11FFF), (0x12FF1, 0x12FF2),
    (0x16E97, 0x16E9A), (0x16FE2, 0x16FE2), (0x1E95E, 0x1E95F))
# punctuation in its tables that Python 3.12 files elsewhere
EXTRA_PUNCT = frozenset({0x166D, 0x111C9})
# non-spacing marks newer than its tables: not stripped
KEEP_MARKS = (
    (0x7FD, 0x7FD), (0x898, 0x89F), (0x8CA, 0x8E1), (0x9FE, 0x9FE),
    (0xAFA, 0xAFF), (0xB55, 0xB55), (0xC04, 0xC04), (0xC3C, 0xC3C),
    (0xD00, 0xD00), (0xD3B, 0xD3C), (0xD81, 0xD81), (0xEBA, 0xEBA),
    (0xECE, 0xECE), (0x180F, 0x180F), (0x1885, 0x1886),
    (0x1ABF, 0x1ACE), (0x1DF6, 0x1DFB), (0xA82C, 0xA82C), (0xA8C5, 0xA8C5),
    (0xA8FF, 0xA8FF), (0xA9BD, 0xA9BD), (0x10D24, 0x10D27),
    (0x10EAB, 0x10EAC), (0x10EFD, 0x10EFF), (0x10F46, 0x10F50),
    (0x10F82, 0x10F85), (0x11070, 0x11070), (0x11073, 0x11074),
    (0x110C2, 0x110C2), (0x111C9, 0x111C9), (0x111CF, 0x111CF),
    (0x1123E, 0x1123E), (0x11241, 0x11241), (0x1133B, 0x1133B),
    (0x11438, 0x1143F), (0x11442, 0x11444), (0x11446, 0x11446),
    (0x1145E, 0x1145E), (0x1182F, 0x11837), (0x11839, 0x1183A),
    (0x1193B, 0x1193C), (0x1193E, 0x1193E), (0x11943, 0x11943),
    (0x119D4, 0x119D7), (0x119DA, 0x119DB), (0x119E0, 0x119E0),
    (0x11A01, 0x11A0A), (0x11A33, 0x11A38), (0x11A3B, 0x11A3E),
    (0x11A47, 0x11A47), (0x11A51, 0x11A56), (0x11A59, 0x11A5B),
    (0x11A8A, 0x11A96), (0x11A98, 0x11A99), (0x11C30, 0x11C36),
    (0x11C38, 0x11C3D), (0x11C3F, 0x11C3F), (0x11C92, 0x11CA7),
    (0x11CAA, 0x11CB0), (0x11CB2, 0x11CB3), (0x11CB5, 0x11CB6),
    (0x11D31, 0x11D36), (0x11D3A, 0x11D3A), (0x11D3C, 0x11D3D),
    (0x11D3F, 0x11D45), (0x11D47, 0x11D47), (0x11D90, 0x11D91),
    (0x11D95, 0x11D95), (0x11D97, 0x11D97), (0x11EF3, 0x11EF4),
    (0x11F00, 0x11F01), (0x11F36, 0x11F3A), (0x11F40, 0x11F40),
    (0x11F42, 0x11F42), (0x13440, 0x13440), (0x13447, 0x13455),
    (0x16F4F, 0x16F4F), (0x16FE4, 0x16FE4), (0x1CF00, 0x1CF2D),
    (0x1CF30, 0x1CF46), (0x1E000, 0x1E006), (0x1E008, 0x1E018),
    (0x1E01B, 0x1E021), (0x1E023, 0x1E024), (0x1E026, 0x1E02A),
    (0x1E08F, 0x1E08F), (0x1E130, 0x1E136), (0x1E2AE, 0x1E2AE),
    (0x1E2EC, 0x1E2EF), (0x1E4EC, 0x1E4EF), (0x1E944, 0x1E94A))
# a spacing mark its tables still call non-spacing: stripped
EXTRA_MARKS = frozenset({0x1734})
# a character its NFD leaves whole
NO_DECOMPOSE = "\U00011938"
# lowercase mappings newer than Python's: (first, last, offset or target)
LOWER_EXTRA = ((0x1C89, 0x1C89, 1), (0xA7CB, 0xA7CB, "ɤ"),
               (0xA7CC, 0xA7CC, 1), (0xA7CE, 0xA7CE, 1),
               (0xA7D2, 0xA7D2, 1), (0xA7D4, 0xA7D4, 1),
               (0xA7DA, 0xA7DA, 1), (0xA7DC, 0xA7DC, "ƛ"),
               (0x10D50, 0x10D65, 0x20), (0x16EA0, 0x16EB8, 0x1B))


def _in(cp: int, ranges) -> bool:
    return any(a <= cp <= b for a, b in ranges)


def _lower_table() -> Dict[int, str]:
    # Σ → σ first: str.lower applies the final-sigma rule, the fast
    # tokenizer (one character at a time) does not
    table = {0x3A3: "σ"}
    for first, last, to in LOWER_EXTRA:
        for cp in range(first, last + 1):
            table[cp] = to if isinstance(to, str) else chr(cp + to)
    return table


_LOWER = _lower_table()
# ASCII clean_text: \t \n \r become spaces, the other controls go
_ASCII_CLEAN = {c: None for c in (*range(0, 9), 11, 12, *range(14, 32),
                                  127)}
_ASCII_CLEAN.update({9: " ", 10: " ", 13: " "})
_ASCII_PUNCT = r"!-/:-@\[-`{-~"
_ASCII_WORDS = re.compile(
    rf"[^\t\n\x0b\x0c\r {_ASCII_PUNCT}]+|[{_ASCII_PUNCT}]")
_NO_DECOMPOSE = re.compile(f"([{NO_DECOMPOSE}])")
_CJK = re.compile("([" + "".join(f"{chr(a)}-{chr(b)}" for a, b in CJK_RANGES)
                  + "])")


@lru_cache(maxsize=1 << 16)
def is_control(c: str) -> bool:
    """Dropped by ``clean_text`` (besides NUL and U+FFFD)."""
    if c in "\t\n\r":
        return False
    return (unicodedata.category(c) in ("Cc", "Cf", "Co", "Cs")
            and not _in(ord(c), NOT_CONTROL))


@lru_cache(maxsize=1 << 16)
def is_punctuation(c: str) -> bool:
    cp = ord(c)
    if cp < 128:
        return 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 \
            or 123 <= cp <= 126
    return cp in EXTRA_PUNCT or (unicodedata.category(c).startswith("P")
                                 and not _in(cp, NOT_PUNCT))


@lru_cache(maxsize=1 << 16)
def is_stripped_mark(c: str) -> bool:
    cp = ord(c)
    return cp in EXTRA_MARKS or (unicodedata.category(c) == "Mn"
                                 and not _in(cp, KEEP_MARKS))


def lowercase(text: str) -> str:
    """Each character lowercased on its own, as the fast tokenizer does."""
    return text.translate(_LOWER).lower()


def strip_accents(text: str) -> str:
    parts = _NO_DECOMPOSE.split(text)
    text = "".join(p if p == NO_DECOMPOSE else unicodedata.normalize("NFD", p)
                   for p in parts)
    return "".join(c for c in text if not is_stripped_mark(c))


class BertNormalizer:
    """The fast tokenizer's ``BertNormalizer``."""

    def __init__(self, clean_text: bool = True,
                 handle_chinese_chars: bool = True,
                 strip_accents: Optional[bool] = None,
                 lowercase: bool = True):
        self.clean_text = clean_text
        self.handle_chinese_chars = handle_chinese_chars
        self.strip_accents = lowercase if strip_accents is None \
            else strip_accents
        self.lowercase = lowercase

    def __call__(self, text: str) -> str:
        if text.isascii():               # no CJK, no marks, no Σ
            if self.clean_text:
                text = text.translate(_ASCII_CLEAN)
            return text.lower() if self.lowercase else text
        if self.clean_text:
            text = "".join(
                " " if c in WHITESPACE else c for c in text
                if not (c == "\x00" or c == "�" or is_control(c)))
        if self.handle_chinese_chars:
            text = _CJK.sub(r" \1 ", text)
        if self.strip_accents:
            text = strip_accents(text)
        if self.lowercase:
            text = lowercase(text)
        return text


def pre_tokenize(text: str) -> List[str]:
    """``BertPreTokenizer``: split on whitespace and around punctuation."""
    if text.isascii():
        return _ASCII_WORDS.findall(text)
    words, word = [], []
    for c in text:
        if c in WHITESPACE or is_punctuation(c):
            if word:
                words.append("".join(word))
                word = []
            if c not in WHITESPACE:
                words.append(c)
        else:
            word.append(c)
    if word:
        words.append("".join(word))
    return words


def split_added(text: str, tokens: Dict[str, int]) -> List:
    """``text`` cut around every occurrence of ``tokens`` (content → id),
    leftmost-longest: a list of strings and ids."""
    if not tokens or not text:
        return [text] if text else []
    longest = max(len(t) for t in tokens)
    firsts = {t[0] for t in tokens}
    out, start, i = [], 0, 0
    while i < len(text):
        if text[i] in firsts:
            for n in range(min(longest, len(text) - i), 0, -1):
                hit = tokens.get(text[i:i + n])
                if hit is not None:
                    if i > start:
                        out.append(text[start:i])
                    out.append(hit)
                    i = start = i + n
                    break
            else:
                i += 1
        else:
            i += 1
    if start < len(text):
        out.append(text[start:])
    return out


class WordPieceTokenizer:
    """``BertTokenizerFast`` for a single text sequence (see the module
    docstring)."""

    def __init__(self, vocab: Dict[str, int], normalizer: BertNormalizer,
                 unk_token: str = "[UNK]", cls_token: str = "[CLS]",
                 sep_token: str = "[SEP]", pad_token: Optional[str] = "[PAD]",
                 prefix: str = "##", max_input_chars_per_word: int = 100,
                 added: Optional[Dict[str, int]] = None):
        self.vocab = vocab
        self.normalizer = normalizer
        self.prefix = prefix
        self.max_input_chars_per_word = max_input_chars_per_word
        self.added = dict(added or {})        # content → id, split out raw
        ids = dict(vocab)
        ids.update(self.added)
        for name, token in (("unk", unk_token), ("cls", cls_token),
                            ("sep", sep_token)):
            if token not in ids:
                raise ValueError(f"the {name} token {token!r} has no id")
        self.unk_id = ids[unk_token]
        self.cls_id, self.sep_id = ids[cls_token], ids[sep_token]
        self.pad_token_id = ids.get(pad_token) if pad_token else None
        self._words: Dict[str, Tuple[int, ...]] = {}

    # -- reading a checkpoint directory -----------------------------------

    @classmethod
    def from_dir(cls, directory: str) -> "WordPieceTokenizer":
        def optional(name):
            path = os.path.join(directory, name)
            return read_json(path) if os.path.isfile(path) else {}

        cfg = optional("tokenizer_config.json")
        if "auto_map" in cfg:
            raise NotImplementedError(
                f"{directory}: a remote-code tokenizer ({cfg['auto_map']}); "
                + NOT_PORTED)
        klass = cfg.get("tokenizer_class")
        if klass is None:
            model_type = optional("config.json").get("model_type")
            if model_type != "bert":
                raise NotImplementedError(
                    f"{directory}: no tokenizer_class, and model_type "
                    f"{model_type!r} is not bert; " + NOT_PORTED)
        elif klass not in BERT_CLASSES:
            raise NotImplementedError(
                f"{directory}: tokenizer class {klass}; " + NOT_PORTED)
        for key in ("padding_side", "truncation_side"):
            if cfg.get(key, "right") != "right":
                raise NotImplementedError(
                    f"{directory}: {key} {cfg[key]!r}; only right padding "
                    "and truncation are ported " + SEE_ROADMAP)
        specials = dict(DEFAULT_SPECIALS)
        specials.update({k: cfg[k] for k in SPECIAL_KEYS if k in cfg})
        if "added_tokens_decoder" not in cfg:
            specials.update(optional("special_tokens_map.json"))
        specials = {k: v["content"] if isinstance(v, dict) else v
                    for k, v in specials.items() if k in SPECIAL_KEYS}
        settings = dict(
            lowercase=cfg.get("do_lower_case", True),
            strip_accents=cfg.get("strip_accents"),
            handle_chinese_chars=cfg.get("tokenize_chinese_chars", True))

        path = os.path.join(directory, "tokenizer.json")
        if os.path.isfile(path):
            return cls._from_tokenizer_json(read_json(path), settings,
                                            specials, path)
        vocab = read_vocab(os.path.join(directory, "vocab.txt"))
        decoder = cfg.get("added_tokens_decoder", {})
        _check_added(decoder.values())
        added = {v["content"]: int(k) for k, v in decoder.items()}
        extra = len(vocab)
        for key in SPECIAL_KEYS:
            token = specials.get(key)
            if token is None or token in added:
                continue
            if token in vocab:
                added[token] = vocab[token]
            else:                         # appended past the vocabulary
                added[token], extra = extra, extra + 1
        return cls(vocab, BertNormalizer(clean_text=True, **settings),
                   unk_token=specials["unk_token"],
                   cls_token=specials["cls_token"],
                   sep_token=specials["sep_token"],
                   pad_token=specials.get("pad_token"), added=added)

    @classmethod
    def _from_tokenizer_json(cls, tj: dict, settings: dict, specials: dict,
                             path: str):
        """tokenizer.json's vocabulary and added tokens; its normaliser's
        ``settings`` are tokenizer_config's, as ``BertTokenizerFast.__init__``
        resets them."""
        model = tj.get("model") or {}
        if model.get("type") != "WordPiece":
            raise NotImplementedError(
                f"{path}: a {model.get('type')} model; " + NOT_PORTED)
        for key, want in (("normalizer", "BertNormalizer"),
                          ("pre_tokenizer", "BertPreTokenizer")):
            got = (tj.get(key) or {}).get("type")
            if got != want:
                raise NotImplementedError(
                    f"{path}: {key} {got}; only {want} is ported "
                    + SEE_ROADMAP)
        cls_token, sep_token = _template(tj.get("post_processor"), path)
        normalizer = BertNormalizer(
            clean_text=tj["normalizer"].get("clean_text", True), **settings)
        entries = tj.get("added_tokens") or []
        _check_added(entries)
        return cls(dict(model["vocab"]), normalizer,
                   unk_token=model.get("unk_token", "[UNK]"),
                   cls_token=cls_token, sep_token=sep_token,
                   pad_token=specials.get("pad_token"),
                   prefix=model.get("continuing_subword_prefix", "##"),
                   max_input_chars_per_word=int(
                       model.get("max_input_chars_per_word", 100)),
                   added={t["content"]: int(t["id"]) for t in entries})

    # -- tokenizing ---------------------------------------------------------

    def word_ids(self, word: str) -> Tuple[int, ...]:
        """The WordPiece model on one pre-tokenized word (memoised)."""
        ids = self._words.get(word)
        if ids is None:
            ids = self._wordpiece(word)
            if len(self._words) >= 1 << 20:
                self._words.clear()
            self._words[word] = ids
        return ids

    def _wordpiece(self, word: str) -> Tuple[int, ...]:
        if len(word) > self.max_input_chars_per_word:
            return (self.unk_id,)
        out, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = word[start:end] if start == 0 \
                    else self.prefix + word[start:end]
                tid = self.vocab.get(piece)
                if tid is not None:
                    break
                end -= 1
            else:                         # no piece matched: the word is bad
                return (self.unk_id,)
            out.append(tid)
            start = end
        return tuple(out)

    def encode(self, text: str) -> List[int]:
        """The ids of ``text`` without the special tokens around it."""
        ids: List[int] = []
        for part in split_added(text, self.added):
            if not isinstance(part, str):
                ids.append(part)
                continue
            for word in pre_tokenize(self.normalizer(part)):
                ids.extend(self.word_ids(word))
        return ids

    def __call__(self, texts: Iterable[str], max_length: int = 512
                 ) -> Dict[str, np.ndarray]:
        if max_length < 2:
            raise ValueError(f"max_length {max_length} leaves no room for "
                             "[CLS] and [SEP]")
        rows = []
        for text in texts:
            if not isinstance(text, str):
                raise TypeError(f"a text is {type(text).__name__}, not str")
            rows.append([self.cls_id] + self.encode(text)[:max_length - 2]
                        + [self.sep_id])
        if self.pad_token_id is None:
            raise ValueError("padding needs a pad token, and the tokenizer "
                             "has none (as transformers refuses)")
        width = max((len(r) for r in rows), default=0)
        ids = np.full((len(rows), width), self.pad_token_id, dtype=np.int64)
        mask = np.zeros((len(rows), width), dtype=np.int64)
        for i, row in enumerate(rows):
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return {"input_ids": ids,
                "token_type_ids": np.zeros_like(ids),
                "attention_mask": mask}


def read_vocab(path: str) -> Dict[str, int]:
    """``vocab.txt``: a token a line, its line number its id (a repeated
    token keeps its last line, as ``load_vocab`` does)."""
    with open(path, encoding="utf-8") as f:
        return {line.rstrip("\n"): i for i, line in enumerate(f)}


def _check_added(entries) -> None:
    for entry in entries:
        flags = [k for k in ("lstrip", "rstrip", "single_word",
                             "normalized") if entry.get(k)]
        if flags:
            raise NotImplementedError(
                f"added token {entry.get('content')!r} sets {flags}; only "
                "added tokens split from the raw text are ported "
                + SEE_ROADMAP)


def _template(post: Optional[dict], path: str) -> Tuple[str, str]:
    """The ``[CLS]`` and ``[SEP]`` tokens of a single-sequence template."""
    if (post or {}).get("type") == "TemplateProcessing":
        single = post["single"]
        shape = [next(iter(p)) for p in single]
        if shape == ["SpecialToken", "Sequence", "SpecialToken"] \
                and all(next(iter(p.values()))["type_id"] == 0
                        for p in single):
            return (single[0]["SpecialToken"]["id"],
                    single[2]["SpecialToken"]["id"])
    raise NotImplementedError(f"{path}: post-processor {post}; only "
                              "[CLS] $A [SEP] is ported " + SEE_ROADMAP)
