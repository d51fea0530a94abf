"""Every C entry point of the port's CUDA sources against the ctypes table
that loads it (_build.SIGNATURES): the same names, and for each the same
arity and, argument by argument, pointer / int / long long / float. A
mismatch there passes the wrong bits to the card without any error, and
only a run on the card would show it."""

import ctypes
import re

import pytest

from gpt2_vision_language_tpu_torch import _build

DECL = re.compile(r'extern "C" int (gpt2vl_\w+)\(([^)]*)\)', re.S)


def _ctype(param: str):
    p = " ".join(param.split())
    if "*" in p:
        return ctypes.c_void_p
    for prefix, ct in (("long long", ctypes.c_longlong), ("int", ctypes.c_int),
                       ("float", ctypes.c_float)):
        if p.startswith(prefix + " ") or p == prefix:
            return ct
    raise AssertionError(f"unknown C parameter type: {param!r}")


def _declarations():
    out = {}
    for src in _build.sources():
        for name, params in DECL.findall(src.read_text()):
            assert name not in out, f"{name} declared twice"
            params = params.strip()
            out[name] = [] if params in ("", "void") else [_ctype(p) for p in params.split(",")]
    return out


def test_every_declaration_is_registered():
    assert set(_declarations()) == set(_build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_declaration(name):
    decl = _declarations()[name]
    table = _build.SIGNATURES[name]
    assert len(decl) == len(table), (name, len(decl), len(table))
    assert [t.__name__ for t in decl] == [t.__name__ for t in table]


def test_sources_include_only_their_own_headers():
    """The two Hopper kernels share csrc/hopper.cuh, and the library name
    hashes it with the sources, so an edit of the header rebuilds them."""
    heads = {p.name for p in _build.headers()}
    assert heads == {"hopper.cuh"}
    for name in ("flash_general_fwd.cu", "flash_fused_bwd.cu"):
        src = (_build.CSRC / name).read_text()
        assert '#include "hopper.cuh"' in src and "nvcuda::wmma" not in src
        assert "wgmma" in (_build.CSRC / "hopper.cuh").read_text()
