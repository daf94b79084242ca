"""The config layer (counterpart of biomedkg_tpu/config.py): a mini-Hydra
over ``configs/`` with no PyYAML, which the card's machine lacks.

The reference composes a root yaml with a ``defaults`` list of group files
(``configs/data/primekg.yaml``, ``configs/model/kge.yaml``), applies dotted
command-line overrides (``data.batch_size=64``) and instantiates the data
module from its ``_target_``. This module does the same, so the
``scripts/*.sh`` override vocabulary works unchanged on the port:

* ``load_yaml`` / ``load_yaml_file`` read the YAML subset the repo's
  configs use (block maps and lists, lists of one-key maps, flow lists and
  maps, single- and double-quoted strings, ``#`` comments) and resolve
  plain scalars as PyYAML's ``safe_load`` does (YAML 1.1): ``0,1`` and
  ``1e-3`` stay strings, ``0.001`` is a float, ``none`` is the string
  "none" and ``null`` / ``~`` / an empty value None, ``yes`` / ``on`` are
  True. Numbers other than decimal ones (hex, octal, binary,
  sexagesimal), escapes other than one character's, dates, anchors, tags
  and multi-line scalars are refused;
* ``load_config`` composes with overrides in Hydra's grammar
  (``_parse_value``: ``1e-3`` is a float there, ``[..]`` / ``{..}`` values
  are flow collections), ``~key`` deletes, ``+key`` adds, and a dotless
  ``group=name`` selects a group file;
* ``instantiate`` builds the class ``_target_`` names, with a
  ``biomedkg_tpu.`` target read as the same name under
  ``biomedkg_tpu_torch.`` (the configs name the JAX package's classes, and
  the port never imports it).

A relative config directory resolves against the working directory, then
against the repository that holds this package, so ``python -m
biomedkg_tpu_torch.train_kge`` finds ``configs/`` from any directory.
"""

from __future__ import annotations

import importlib
import re
import sys
from pathlib import Path
from typing import Any, List, Optional, Tuple

REPO_ROOT = Path(__file__).resolve().parent.parent
CONFIG_DIR = "configs"
_JAX_PACKAGE = "biomedkg_tpu."
_PORT_PACKAGE = "biomedkg_tpu_torch."


class Config(dict):
    """Dict with attribute access, nested merge and dotted get/set."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, dict) and not isinstance(value, Config):
            return Config({k: Config._wrap(v) for k, v in value.items()})
        if isinstance(value, list):
            return [Config._wrap(v) for v in value]
        return value

    def merge(self, other: dict) -> "Config":
        """Recursive in-place merge; ``other`` wins on conflicts."""
        for key, value in other.items():
            if (key in self and isinstance(self[key], dict)
                    and isinstance(value, dict)):
                node = self[key]
                if not isinstance(node, Config):
                    node = Config._wrap(node)
                    self[key] = node
                node.merge(value)
            else:
                self[key] = Config._wrap(value)
        return self

    def set_dotted(self, dotted_key: str, value: Any) -> None:
        node = self
        parts = dotted_key.split(".")
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], dict):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = Config._wrap(value)

    def delete_dotted(self, dotted_key: str) -> None:
        node: Any = self
        parts = dotted_key.split(".")
        for part in parts[:-1]:
            if not isinstance(node, dict) or part not in node:
                return
            node = node[part]
        if isinstance(node, dict):
            node.pop(parts[-1], None)

    def get_dotted(self, dotted_key: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted_key.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def to_dict(self) -> dict:
        def _unwrap(value: Any) -> Any:
            if isinstance(value, dict):
                return {k: _unwrap(v) for k, v in value.items()}
            if isinstance(value, list):
                return [_unwrap(v) for v in value]
            return value

        return _unwrap(self)


# -- the YAML subset ---------------------------------------------------------

class YAMLError(ValueError):
    pass


# PyYAML's implicit resolvers for plain scalars (YAML 1.1), in the order
# PyYAML tries them, cut to the forms the configs use: decimal ints and
# floats. The other numbers YAML 1.1 resolves (binary, octal, hex,
# sexagesimal) are refused, not read as strings
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_OTHER_NUMBER = re.compile(r"^[-+]?(?:0b[0-1_]+|0[0-7_]+|0x[0-9a-fA-F_]+"
                           r"|[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\"}


def _resolve_float(text: str) -> float:
    return float(text.replace("_", "").lower().replace(".inf", "inf")
                 .replace(".nan", "nan"))


def resolve_plain(text: str) -> Any:
    """A plain (unquoted) scalar as PyYAML's ``safe_load`` resolves it."""
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        return _resolve_float(text)
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _OTHER_NUMBER.match(text):
        raise YAMLError(f"only decimal numbers are supported: {text!r}")
    if _NULL.match(text):
        return None
    if _TIMESTAMP.match(text):
        raise YAMLError(f"dates are not supported: {text!r}")
    if text[:1] in ("&", "*", "!", "|", ">", "%", "@", "`"):
        raise YAMLError(f"unsupported YAML syntax: {text!r}")
    return text


def _double_quoted(body: str) -> str:
    out, i = [], 0
    while i < len(body):
        ch = body[i]
        if ch != "\\":
            out.append(ch)
            i += 1
            continue
        esc = body[i + 1]
        if esc not in _ESCAPES:
            raise YAMLError(f"unsupported escape \\{esc}")
        out.append(_ESCAPES[esc])
        i += 2
    return "".join(out)


def _quoted_end(text: str, start: int) -> int:
    """The index of the quote that closes the string opened at ``start``."""
    quote = text[start]
    i = start + 1
    while i < len(text):
        if quote == "'" and text[i] == "'":
            if text[i + 1:i + 2] == "'":
                i += 2
                continue
            return i
        if quote == '"' and text[i] == "\\":
            i += 2
            continue
        if quote == '"' and text[i] == '"':
            return i
        i += 1
    raise YAMLError(f"unterminated quoted scalar: {text[start:]!r}")


def _quoted_value(text: str, start: int, end: int) -> str:
    body = text[start + 1:end]
    if text[start] == "'":
        return body.replace("''", "'")
    return _double_quoted(body)


def _strip_comment(line: str) -> str:
    """``line`` without its ``# ...`` comment. A quote opens a quoted scalar
    only where a value starts (after ``:``, ``-``, ``[``, ``{``, ``,`` or
    at the line's start), so an apostrophe inside a plain scalar is text."""
    i, last = 0, ""
    while i < len(line):
        ch = line[i]
        if ch in "'\"" and last in ("", ":", "-", "[", "{", ","):
            i = _quoted_end(line, i) + 1
            last = "q"
            continue
        if ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        if not ch.isspace():
            last = ch
        i += 1
    return line.rstrip()


class _Flow:
    """A recursive-descent reader of one flow value: ``[..]``, ``{..}``, a
    quoted scalar, or a plain scalar that runs to the next ``,``, ``]`` or
    ``}`` (inside a collection) or to the end."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def _skip(self):
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1

    def value(self, in_flow: bool) -> Any:
        self._skip()
        ch = self.text[self.pos:self.pos + 1]
        if ch == "[":
            return self._seq()
        if ch == "{":
            return self._map()
        if ch in ("'", '"'):
            end = _quoted_end(self.text, self.pos)
            out = _quoted_value(self.text, self.pos, end)
            self.pos = end + 1
            return out
        stops = ",[]{}" if in_flow else ""
        start = self.pos
        while self.pos < len(self.text) and self.text[self.pos] not in stops:
            if in_flow and self.text[self.pos] == ":" and \
                    self.text[self.pos + 1:self.pos + 2] in (
                        " ", "", ",", "]", "}"):
                break
            self.pos += 1
        return resolve_plain(self.text[start:self.pos].strip())

    def _expect(self, ch: str):
        self._skip()
        if self.text[self.pos:self.pos + 1] != ch:
            raise YAMLError(f"expected {ch!r} at {self.text[self.pos:]!r} "
                            f"in {self.text!r}")
        self.pos += 1

    def _seq(self) -> list:
        self._expect("[")
        out = []
        self._skip()
        while self.text[self.pos:self.pos + 1] != "]":
            out.append(self.value(True))
            self._skip()
            if self.text[self.pos:self.pos + 1] == ",":
                self.pos += 1
                self._skip()
            elif self.text[self.pos:self.pos + 1] != "]":
                raise YAMLError(f"bad flow sequence {self.text!r}")
        self.pos += 1
        return out

    def _map(self) -> dict:
        self._expect("{")
        out = {}
        self._skip()
        while self.text[self.pos:self.pos + 1] != "}":
            key = self.value(True)
            self._expect(":")
            self._skip()
            nxt = self.text[self.pos:self.pos + 1]
            out[key] = None if nxt in (",", "}") else self.value(True)
            self._skip()
            if self.text[self.pos:self.pos + 1] == ",":
                self.pos += 1
                self._skip()
            elif self.text[self.pos:self.pos + 1] != "}":
                raise YAMLError(f"bad flow mapping {self.text!r}")
        self.pos += 1
        return out

    def whole(self) -> Any:
        out = self.value(False)
        self._skip()
        if self.pos != len(self.text):
            raise YAMLError(f"trailing text in {self.text!r}")
        return out


def _inline(text: str) -> Any:
    """The value written on a line after ``key:`` or ``-``."""
    if text[:1] in ("[", "{", "'", '"'):
        return _Flow(text).whole()
    return resolve_plain(text)


def _split_key(content: str) -> Optional[Tuple[Any, str]]:
    """(key, rest) when ``content`` is ``key: rest`` or ``key:``, else
    None."""
    if content[:1] in ("'", '"'):
        end = _quoted_end(content, 0)
        after = content[end + 1:]
        if after.startswith(":") and after[1:2] in ("", " ", "\t"):
            return _quoted_value(content, 0, end), after[1:].strip()
        return None
    if content[:1] in ("[", "{"):
        return None
    for m in re.finditer(":", content):
        nxt = content[m.end():m.end() + 1]
        if nxt in ("", " ", "\t"):
            return (resolve_plain(content[:m.start()].rstrip()),
                    content[m.end():].strip())
    return None


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


class _Block:
    def __init__(self, text: str):
        self.lines: List[Tuple[int, str]] = []
        for raw in text.splitlines():
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise YAMLError("tabs in indentation")
            line = _strip_comment(raw)
            if not line.strip():
                continue
            if line.strip() in ("---", "..."):
                raise YAMLError("multiple documents are not supported")
            indent = len(line) - len(line.lstrip(" "))
            self.lines.append((indent, line.strip()))
        self.i = 0

    def _peek(self) -> Optional[Tuple[int, str]]:
        return self.lines[self.i] if self.i < len(self.lines) else None

    def node(self, indent: int) -> Any:
        _, content = self.lines[self.i]
        if _is_item(content):
            return self._seq(indent)
        if _split_key(content) is None:
            self.i += 1
            value = _inline(content)
            nxt = self._peek()
            if nxt is not None and nxt[0] > indent:
                raise YAMLError("multi-line scalars are not supported")
            return value
        return self._map(indent)

    def _value_after(self, rest: str, indent: int, list_here: bool) -> Any:
        """The value of a ``key:`` or ``-`` whose inline text is ``rest``."""
        if rest:
            nxt = self._peek()
            if nxt is not None and nxt[0] > indent:
                raise YAMLError("multi-line scalars are not supported: "
                                f"{rest!r}")
            return _inline(rest)
        nxt = self._peek()
        if nxt is None:
            return None
        if nxt[0] > indent or (list_here and nxt[0] == indent
                               and _is_item(nxt[1])):
            return self.node(nxt[0])
        return None

    def _map(self, indent: int) -> dict:
        out = {}
        while True:
            nxt = self._peek()
            if nxt is None or nxt[0] < indent:
                return out
            if nxt[0] > indent or _is_item(nxt[1]):
                raise YAMLError(f"bad indentation at {nxt[1]!r}")
            split = _split_key(nxt[1])
            if split is None:
                raise YAMLError(f"expected 'key: value', got {nxt[1]!r}")
            key, rest = split
            self.i += 1
            out[key] = self._value_after(rest, indent, list_here=True)

    def _seq(self, indent: int) -> list:
        out = []
        while True:
            nxt = self._peek()
            if nxt is None or nxt[0] < indent:
                return out
            if nxt[0] > indent or not _is_item(nxt[1]):
                if nxt[0] == indent:
                    return out
                raise YAMLError(f"bad indentation at {nxt[1]!r}")
            rest = nxt[1][1:].lstrip(" ")
            if rest and (_is_item(rest) or _split_key(rest) is not None):
                # "- key: value" (or "- - x"): the item is a block node
                # whose first line starts at the text after the dash
                column = indent + len(nxt[1]) - len(rest)
                self.lines[self.i] = (column, rest)
                out.append(self.node(column))
            else:
                self.i += 1
                out.append(self._value_after(rest, indent, list_here=False))


def load_yaml(text: str) -> Any:
    """One YAML document of the configs' subset, resolved as PyYAML's
    ``safe_load`` resolves it (None for an empty document)."""
    block = _Block(text)
    if not block.lines:
        return None
    out = block.node(block.lines[0][0])
    if block.i != len(block.lines):
        raise YAMLError(f"unexpected text at {block.lines[block.i][1]!r}")
    return out


def load_yaml_file(path) -> Any:
    with open(path) as f:
        return load_yaml(f.read())


# -- composition -----------------------------------------------------------

def _parse_value(text: str) -> Any:
    """An override value in Hydra's grammar, not raw YAML 1.1: ints, floats
    including scientific notation (``1e-3``), true / false / null / none
    literals, and flow collections or quoted strings for values starting
    with ``[``, ``{`` or a quote; anything else (``on``, ``0,1``, ``3:04``)
    stays the string it was."""
    s = text.strip()
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none", "~"):
        return None
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    if s[:1] in ("[", "{", "'", '"'):
        try:
            return load_yaml(s)
        except (YAMLError, IndexError, ValueError):
            return text
    return text


def _load_yaml(path: Path) -> Config:
    raw = load_yaml_file(path) or {}
    if not isinstance(raw, dict):
        raise ValueError(f"Config file {path} must contain a mapping")
    return Config._wrap(raw)


def _compose_file(path: Path) -> Config:
    """One yaml file with its own ``defaults`` list resolved: a group
    file's ``defaults: [base]`` merges the sibling into the same node."""
    raw = _load_yaml(path)
    defaults = raw.pop("defaults", [])
    composed = Config()
    self_inserted = False
    for entry in defaults:
        if entry == "_self_":
            composed.merge(raw)
            self_inserted = True
        elif isinstance(entry, str):
            composed.merge(_compose_file(path.parent / f"{entry}.yaml"))
        elif isinstance(entry, dict):
            for group, name in entry.items():
                if group == "_self_":
                    continue
                sub = _compose_file(path.parent / str(group) / f"{name}.yaml")
                composed.merge(Config({group: sub}))
    if not self_inserted:
        composed.merge(raw)
    return composed


def resolve_config_dir(config_dir) -> Path:
    """``config_dir`` as given when absolute or present under the working
    directory, else under the repository that holds this package."""
    path = Path(config_dir)
    if not path.is_absolute() and not path.exists() \
            and (REPO_ROOT / path).exists():
        return REPO_ROOT / path
    return path


def load_config(config_dir, config_name: str,
                overrides: Optional[List[str]] = None) -> Config:
    """``{config_dir}/{config_name}.yaml`` composed, then the overrides:
    ``key=value`` and ``a.b=value``; ``+key=value`` adds; ``~key`` (or
    ``~key=value``) deletes; a dotless ``group=name`` whose
    ``{config_dir}/{group}/{name}.yaml`` exists selects that group file,
    replacing the composed group."""
    config_dir = resolve_config_dir(config_dir)
    cfg = _compose_file(config_dir / f"{config_name}.yaml")
    for override in overrides or []:
        if override.startswith("~"):
            cfg.delete_dotted(override[1:].partition("=")[0])
            continue
        if "=" not in override:
            raise ValueError(
                f"Malformed override (expected key=value): {override!r}")
        key, _, value = override.partition("=")
        key = key.lstrip("+")
        if "." not in key and (config_dir / key / f"{value}.yaml").exists():
            cfg[key] = _compose_file(config_dir / key / f"{value}.yaml")
            continue
        cfg.set_dotted(key, _parse_value(value))
    return cfg


def cli_overrides(argv: Optional[List[str]] = None) -> List[str]:
    """The ``key=value`` and ``~key`` arguments of ``argv``, flags
    skipped."""
    argv = sys.argv[1:] if argv is None else argv
    return [a for a in argv
            if ("=" in a or a.startswith("~")) and not a.startswith("--")]


def port_target(target: str) -> str:
    """The port's name for a ``_target_``: a ``biomedkg_tpu.`` class is
    looked up under ``biomedkg_tpu_torch.``."""
    if target.startswith(_JAX_PACKAGE):
        return _PORT_PACKAGE + target[len(_JAX_PACKAGE):]
    return target


def instantiate(node: Config, **kwargs: Any) -> Any:
    """The object ``node["_target_"]`` names, built from the node's other
    keys and ``kwargs`` (Hydra's ``instantiate``)."""
    node = Config._wrap(dict(node))
    module_name, _, attr = port_target(node.pop("_target_")).rpartition(".")
    obj = getattr(importlib.import_module(module_name), attr)
    params = dict(node)
    params.update(kwargs)
    return obj(**params)


def main(config_path: str, config_name: str):
    """Decorator in place of ``@hydra.main``: the wrapped function gets the
    composed :class:`Config`, the overrides read from ``sys.argv``."""

    def decorator(fn):
        def wrapper():
            cfg = load_config(config_path, config_name, cli_overrides())
            return fn(cfg)

        wrapper.__name__ = fn.__name__
        return wrapper

    return decorator
