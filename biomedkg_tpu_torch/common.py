"""Cross-cutting helpers (counterpart of biomedkg_tpu/common.py)."""

from __future__ import annotations

import re

_LETTERS = re.compile("[a-zA-Z]+")


def clean_name(input_string: str) -> str:
    """Strip a node-type / relation name down to its letters."""
    return "".join(_LETTERS.findall(input_string))
