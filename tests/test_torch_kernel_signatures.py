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


def _includes(path):
    """The repository headers `path` includes, transitively."""
    found, todo = set(), [path]
    while todo:
        for name in re.findall(r'#include "([^"]+)"', todo.pop().read_text()):
            if name not in found:
                found.add(name)
                todo.append(_build.CSRC / name)
    return found


# source -> the repository headers it includes, transitively; every other
# source includes none
SHARED = {"flash_general_fwd.cu": {"flash_fwd_sm90.cuh", "hopper.cuh"},
          "flash_lse_fwd.cu": {"flash_fwd_sm90.cuh", "hopper.cuh"},
          "flash_fwd.cu": {"flash_fwd_sm90.cuh", "hopper.cuh"},
          "flash_fused_bwd.cu": {"flash_bwd_sm90.cuh", "hopper.cuh"},
          "flash_dkv_bwd.cu": {"flash_bwd_sm90.cuh", "hopper.cuh"},
          "flash_dq_bwd.cu": {"hopper.cuh"}}


def test_sources_include_only_their_own_headers():
    """The six Hopper kernels share csrc/hopper.cuh, five of them through two
    headers, the forward main loop (K2b, K2a, K1-fwd) and the key-major
    backward (K3c, K3b); the query-major dq kernel (K3a) uses hopper.cuh
    alone. The library name hashes every header with the sources, so an edit
    of one rebuilds them. Those sources issue wgmma and load by TMA, and none
    of them, nor the headers, uses nvcuda::wmma."""
    heads = {p.name for p in _build.headers()}
    assert heads == {"hopper.cuh", "flash_fwd_sm90.cuh", "flash_bwd_sm90.cuh"}
    hopper = (_build.CSRC / "hopper.cuh").read_text()
    assert "wgmma.mma_async" in hopper and "cp.async.bulk.tensor" in hopper
    for name, headers in SHARED.items():
        assert _includes(_build.CSRC / name) == headers, name
        for text in [(_build.CSRC / n).read_text() for n in (name, *headers)]:
            assert "nvcuda::wmma" not in text and "<mma.h>" not in text
    for src in _build.sources():
        if src.name not in SHARED:
            assert not _includes(src), src.name


@pytest.mark.parametrize("name,entry", [("flash_fwd.cu", "gpt2vl_flash_fwd"),
                                        ("flash_dq_bwd.cu", "gpt2vl_flash_general_dq")])
def test_rebuilt_kernel_is_hopper_only(name, entry):
    """K1-fwd and K3a, rebuilt for Hopper: each source holds its entry point
    and its own __global__ kernel, reaches TMA and wgmma through
    csrc/hopper.cuh, and keeps nothing of the wmma kernels it replaced."""
    text = (_build.CSRC / name).read_text()
    assert f'extern "C" int {entry}(' in text
    assert text.count("__global__") == 1
    assert "hopper.cuh" in _includes(_build.CSRC / name)
    for gone in ("nvcuda", "<mma.h>", "wmma::", "load_matrix_sync", "mma_sync("):
        assert gone not in text, (name, gone)


def test_dq_kernel_reads_k_both_ways():
    """K3a forms S from the K tile read K-major and dQ from the same tile
    read MN-major through the transpose bit (mma_m64n64_rs_tb), its dS as a
    register A operand; the D pre-kernel stays in flash_general_bwd.cu."""
    dq = (_build.CSRC / "flash_dq_bwd.cu").read_text()
    assert "mma_m64n64_rs_tb(dqa, sa[kk]" in dq and "tma_load_4d" in dq
    general = (_build.CSRC / "flash_general_bwd.cu").read_text()
    assert 'extern "C" int gpt2vl_flash_rowdot(' in general
    assert "gpt2vl_flash_general_dq" not in general


@pytest.mark.parametrize("header,body", [("flash_fwd_sm90.cuh", "forward_block"),
                                         ("flash_bwd_sm90.cuh", "backward_block")])
def test_main_loop_exists_once(header, body):
    """The forward main loop and the key-major backward consumer are written
    once, in their header: each source that runs them (K2b, K2a and K1-fwd;
    K3c and K3b) only instantiates them, and no source repeats their wgmma
    calls."""
    assert f"__device__ __forceinline__ void {body}(" in (_build.CSRC / header).read_text()
    for src in _build.sources():
        text = src.read_text()
        assert f"void {body}(" not in text
        if header in _includes(src):
            assert "mma_m64n" not in text and "tma_load_4d" not in text, src.name
