"""The port's kernel build (``ops/_build.py``): a library's name hashes its
source and every header the source includes from ``csrc/``, so that an
edited shared header rebuilds each library that includes it. Runs no nvcc.
"""

import os

import pytest

from biomedkg_tpu_torch.ops import _build


@pytest.mark.parametrize("source", ["relmm.cu", "flashnce.cu"])
def test_sources_hash_the_shared_hopper_header(source):
    with open(os.path.join(_build.CSRC, "hopper.cuh"), "rb") as f:
        header = f.read()
    with open(os.path.join(_build.CSRC, source), "rb") as f:
        text = f.read()
    assert b'#include "hopper.cuh"' in text
    got = _build.source_text(os.path.join(_build.CSRC, source))
    assert got == text + header


def test_header_edit_renames_the_library(tmp_path):
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include "b.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("#pragma once\nint b;\n")
    lib = _build.CudaLibrary(str(tmp_path / "k.cu"), {})
    # each file once, in the order of first inclusion
    assert _build.source_text(lib.source) == (
        b'#include "a.cuh"\n#include "b.cuh"\n'
        b'#pragma once\n#include "b.cuh"\n#pragma once\nint b;\n')
    before = lib.built_path()
    assert before == lib.built_path()
    assert os.path.dirname(before) == _build.BUILD_DIR
    (tmp_path / "b.cuh").write_text("#pragma once\nint b2;\n")
    assert lib.built_path() != before
    assert not os.path.exists(lib.built_path())
