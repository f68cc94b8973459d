"""The kernel build (``repro_torch.kernels._build``) without a compiler: a
library is named by the hash of its source, the shared headers
``csrc/*.cuh`` and the flags, so an edit to any of them builds it anew; and
a helper of the shared header is defined there only."""

from __future__ import annotations

import re
import shutil

import pytest

from repro_torch.kernels import _build

HEADER = "hopper.cuh"
USERS = ("tile_matmul", "flash_attention", "flash_attention_bwd")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that the build reads in place of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


@pytest.mark.parametrize("name", _build.KERNELS)
def test_a_library_is_named_anew_when_its_source_changes(csrc, name):
    before = _build._target(name)
    (csrc / f"{name}.cu").write_text((csrc / f"{name}.cu").read_text() + "\n// edited\n")
    assert _build._target(name) != before
    assert _build._target(name).parent == _build.BUILD


@pytest.mark.parametrize("name", _build.KERNELS)
def test_a_library_is_named_anew_when_a_shared_header_changes(csrc, name):
    before = _build._target(name)
    (csrc / HEADER).write_text((csrc / HEADER).read_text() + "\n// edited\n")
    assert _build._target(name) != before


def _defined(text: str) -> set[str]:
    """Names of the functions and constants a CUDA source defines at file
    scope (a line that starts a definition: qualifiers, a type, the name)."""
    pat = re.compile(r"^(?:template <[^>]*>\s*)?(?:__device__ __forceinline__ |inline |constexpr "
                     r"|using )?[\w:<>]+\s+\(?\*?(\w+)\s*(?:\(|=)", re.M)
    return set(pat.findall(text))


def test_the_shared_helpers_are_defined_in_the_header_only():
    header = (_build.CSRC / HEADER).read_text()
    shared = _defined(header)
    assert {"mbar_wait", "sw128_desc", "wgmma_rs256", "desc_k256", "encode_tiled",
            "bind_context", "SW_ATOM"} <= shared
    for name in USERS:
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert f'#include "{HEADER}"' in text, name
        assert not (_defined(text) & shared), (name, sorted(_defined(text) & shared))
