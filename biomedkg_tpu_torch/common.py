"""Cross-cutting helpers (counterpart of biomedkg_tpu/common.py)."""

from __future__ import annotations

import os
import re
from typing import Optional

_LETTERS = re.compile("[a-zA-Z]+")


def clean_name(input_string: str) -> str:
    """Strip a node-type / relation name down to its letters."""
    return "".join(_LETTERS.findall(input_string))


def find_comet_api_key() -> Optional[str]:
    """The Comet API key, if the environment has one (Comet logging is
    optional)."""
    return os.environ.get("COMET_API_KEY")
