"""Every C entry point of the port's CUDA sources against the ctypes table
that loads it (_build.SIGNATURES): the same names, and for each the same
arity and, argument by argument, pointer / int / long long / float. A
mismatch there passes the wrong bits to the card without any error, and
only a run on the card would show it. A source that calls another's entry
point declares it with the same parameters as its definition."""

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
            params = params.strip()
            types = [] if params in ("", "void") else [_ctype(p) for p in params.split(",")]
            assert out.setdefault(name, types) == types, f"{name} declared twice differently"
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
          "flash_dt_fwd.cu": {"flash_fwd_sm90.cuh", "hopper.cuh"},
          "flash_fused_bwd.cu": {"flash_bwd_sm90.cuh", "hopper.cuh"},
          "flash_dkv_bwd.cu": {"flash_bwd_sm90.cuh", "hopper.cuh"},
          "flash_dq_bwd.cu": {"flash_dq_sm90.cuh", "hopper.cuh"},
          "flash_bwd.cu": {"flash_bwd_sm90.cuh", "flash_dq_sm90.cuh", "hopper.cuh"},
          "flash_dt_bwd.cu": {"flash_bwd_sm90.cuh", "flash_dq_sm90.cuh", "hopper.cuh"},
          "ce_fwd.cu": {"hopper.cuh"},
          "ce_bwd.cu": {"hopper.cuh"},
          "flash_fwd_f32.cu": {"flash_f32.cuh"},
          "flash_bwd_f32.cu": {"flash_f32.cuh"},
          "flash_general_fwd_f32.cu": {"flash_f32.cuh"},
          "flash_general_bwd_f32.cu": {"flash_f32.cuh"},
          "flash_lse_fwd_f32.cu": {"flash_f32.cuh"},
          "flash_dt_fwd_f32.cu": {"flash_f32.cuh"},
          "flash_dt_bwd_f32.cu": {"flash_f32.cuh"}}


def test_sources_include_only_their_own_headers():
    """The eleven Hopper kernels share csrc/hopper.cuh, eight of them through
    three headers: the forward main loop (K2b, K2a, K1-fwd, P1), the
    key-major backward (K3c, K3b) and the query-major dq block (K3a); the
    self-attention backward (K1-bwd) and the dt-layout backward (P2) run both
    backward blocks, and the fused LM-head + CE forward (K4) and its logits
    gradient (K4b) include hopper.cuh alone. The fp32 kernels, the self-attention pair, the
    general pair, the split lse forward and the dt-layout pair, share
    csrc/flash_f32.cuh (its FFMA
    register tiles, cp.async copies and blocks). The library name hashes
    every header with the sources, so an edit of one rebuilds them. The
    Hopper sources run wgmma and load by TMA, and none of them, nor the
    headers, uses nvcuda::wmma."""
    heads = {p.name for p in _build.headers()}
    assert heads == {"hopper.cuh", "flash_fwd_sm90.cuh", "flash_bwd_sm90.cuh",
                     "flash_dq_sm90.cuh", "flash_f32.cuh"}
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
                                        ("flash_dq_bwd.cu", "gpt2vl_flash_general_dq"),
                                        ("flash_bwd.cu", "gpt2vl_flash_bwd"),
                                        ("flash_dt_fwd.cu", "gpt2vl_flash_dt_fwd"),
                                        ("flash_dt_bwd.cu", "gpt2vl_flash_dt_bwd")])
def test_rebuilt_kernel_is_hopper_only(name, entry):
    """K1-fwd, K3a, K1-bwd, P1 and P2, rebuilt for Hopper: each source holds its
    entry point and its own __global__ kernel, reaches TMA and wgmma through
    csrc/hopper.cuh, and keeps nothing of the wmma kernels it replaced."""
    text = (_build.CSRC / name).read_text()
    assert f'extern "C" int {entry}(' in text
    assert text.count("__global__") == 1
    assert "hopper.cuh" in _includes(_build.CSRC / name)
    for gone in ("nvcuda", "<mma.h>", "wmma::", "load_matrix_sync", "mma_sync("):
        assert gone not in text, (name, gone)


def test_dq_kernel_reads_k_both_ways():
    """The query-major dq block (K3a, the dq half of K1-bwd) forms S from the
    K tile read K-major and dQ from the same tile read MN-major through the
    transpose bit (mma_m64n64_rs_tb), its dS as a register A operand; the D
    pre-kernel stays in flash_general_bwd.cu, and K1-bwd launches it through
    its entry point."""
    dq = (_build.CSRC / "flash_dq_sm90.cuh").read_text()
    assert "mma_m64n64_rs_tb(dqa, sa[kk]" in dq and "tma_load_4d" in dq
    general = (_build.CSRC / "flash_general_bwd.cu").read_text()
    assert 'extern "C" int gpt2vl_flash_rowdot(' in general
    assert "gpt2vl_flash_general_dq" not in general
    k1 = (_build.CSRC / "flash_bwd.cu").read_text()
    assert "gpt2vl_flash_rowdot(dO, o, dd," in k1


@pytest.mark.parametrize("header,body", [("flash_fwd_sm90.cuh", "forward_block"),
                                         ("flash_bwd_sm90.cuh", "backward_block"),
                                         ("flash_dq_sm90.cuh", "dq_block")])
def test_main_loop_exists_once(header, body):
    """The forward main loop, the key-major backward block and the
    query-major dq block are written once, in their header: each source that
    runs them (K2b, K2a, K1-fwd and P1; K3c, K3b and K1-bwd; K3a and K1-bwd)
    only instantiates them, and no source repeats their wgmma calls."""
    assert f"__device__ __forceinline__ void {body}(" in (_build.CSRC / header).read_text()
    for src in _build.sources():
        text = src.read_text()
        assert f"void {body}(" not in text
        if header in _includes(src):
            assert "mma_m64n" not in text and "tma_load_4d" not in text, src.name


def test_dt_forward_is_the_main_loop_in_its_dt_layout():
    """P1 runs the forward main loop in its dt layout, whose S product reads
    Q and K MN-major (both transpose bits) and whose P V reads V K-major
    (no transpose bit); the bthd instantiations keep the default layout."""
    hopper = (_build.CSRC / "hopper.cuh").read_text()
    assert "m64n128k16.f32.bf16.bf16" in hopper and '"%64, %65, p, 1, 1, 1, 1;' in hopper
    assert '"{%32, %33, %34, %35}, %36, p, 1, 1, 0;' in hopper
    loop = (_build.CSRC / "flash_fwd_sm90.cuh").read_text()
    assert "mma_m64n128_ss_tt(sc," in loop and "mma_m64n64_rs(acc," in loop
    dt = (_build.CSRC / "flash_dt_fwd.cu").read_text()
    assert "forward_block<CONSUMERS, STAGES, HEADS_INNER, Layout::DT>" in dt
    assert "map_dt(" in dt
    for name in ("flash_fwd.cu", "flash_general_fwd.cu", "flash_lse_fwd.cu"):
        assert "Layout::DT" not in (_build.CSRC / name).read_text(), name


def test_self_attention_backward_is_one_grid_of_both_blocks():
    """K1-bwd launches one grid that holds a dk/dv block (the key-major block
    without dQ) and a dq block (the query-major block) for every 128-row
    tile, and sets its shared-memory attribute once per (device, kernel)."""
    k1 = (_build.CSRC / "flash_bwd.cu").read_text()
    assert "backward_block<false, DKV_STAGES>" in k1 and "dq_block<DQ_STAGES>" in k1
    assert "dim3(2 * nt * H, 1, B)" in k1
    assert "set_smem_once(flash_bwd_kernel" in k1 and "cudaFuncSetAttribute" not in k1


def test_dt_backward_is_both_blocks_in_their_dt_layout():
    """P2 runs the key-major dk/dv block (without its dQ half) and the
    query-major dq block in their dt layout, in one grid in the
    self-attention backward's block order, over map_dt tensor maps; dq is
    summed in one block in a fixed order (no fp32 buffer, no reductions in
    global memory, no cast kernel). The bthd sources keep the default
    layout. The dt S^T and dP^T of the dk/dv block read both operands
    MN-major (m64n64k16 with both transpose bits)."""
    dt = (_build.CSRC / "flash_dt_bwd.cu").read_text()
    assert "backward_block<false, DKV_STAGES, Layout::DT>" in dt
    assert "dq_block<DQ_STAGES, Layout::DT>" in dt
    assert "map_dt(" in dt and "set_smem_once(flash_dt_bwd_kernel" in dt
    for gone in ("dq_acc", "red.global", "atomicAdd", "cast_kernel", "gpt2vl_flash_rowdot"):
        assert gone not in dt, gone
    for name in ("flash_bwd.cu", "flash_dq_bwd.cu", "flash_dkv_bwd.cu", "flash_fused_bwd.cu"):
        assert "Layout::DT" not in (_build.CSRC / name).read_text(), name
    hopper = (_build.CSRC / "hopper.cuh").read_text()
    assert "enum class Layout { BTHD, DT };" in hopper
    assert "void mma_m64n64_ss_tt(" in hopper
    kv = (_build.CSRC / "flash_bwd_sm90.cuh").read_text()
    assert "mma_m64n64_ss_tt(st," in kv and "mma_m64n64_rs(dva, pa[kk]" in kv


def test_ce_forward_is_a_wgmma_gemm_with_a_row_epilogue():
    """K4, rebuilt for Hopper: 2-D TMA maps of x and w, wgmma m64n256k16 with
    both operands K-major from shared memory, the per-split row statistics
    merged by a second kernel; its entry points keep their names."""
    text = (_build.CSRC / "ce_fwd.cu").read_text()
    for entry in ("gpt2vl_ce_fwd", "gpt2vl_ce_fwd_block_rows", "gpt2vl_ce_fwd_tile_cols"):
        assert f'extern "C" int {entry}(' in text
    assert "map_2d(" in text and "tma_load_2d(" in text and "mma_m64n256_ss(" in text
    assert "ce_fwd_combine_kernel" in text
    for gone in ("nvcuda", "<mma.h>", "wmma::", "load_matrix_sync", "mma_sync("):
        assert gone not in text, gone
    hopper = (_build.CSRC / "hopper.cuh").read_text()
    assert "m64n256k16.f32.bf16.bf16" in hopper and "cp.async.bulk.tensor.2d" in hopper


def test_ce_backward_is_k4s_main_loop_with_a_p_epilogue():
    """K4b: K4's 2-D TMA maps of x and w and wgmma m64n256k16 main loop, one
    __global__ kernel whose epilogue stores bf16 pairs of P; every output
    tile written by one block, so no atomics and no merge kernel."""
    text = (_build.CSRC / "ce_bwd.cu").read_text()
    assert 'extern "C" int gpt2vl_ce_bwd(' in text
    assert text.count("__global__") == 1
    assert "map_2d(" in text and "tma_load_2d(" in text and "mma_m64n256_ss(" in text
    assert "pack_bf16(" in text
    for gone in ("atomicAdd", "atom.", "red.global", "_combine_kernel", "nvcuda", "<mma.h>",
                 "wmma::"):
        assert gone not in text, gone


@pytest.mark.parametrize("name,entry", [("flash_fwd_f32.cu", "gpt2vl_flash_fwd_f32"),
                                        ("flash_bwd_f32.cu", "gpt2vl_flash_bwd_f32"),
                                        ("flash_general_fwd_f32.cu",
                                         "gpt2vl_flash_general_fwd_f32"),
                                        ("flash_general_bwd_f32.cu",
                                         "gpt2vl_flash_general_bwd_f32"),
                                        ("flash_lse_fwd_f32.cu", "gpt2vl_flash_lse_fwd_f32"),
                                        ("flash_dt_fwd_f32.cu", "gpt2vl_flash_dt_fwd_f32"),
                                        ("flash_dt_bwd_f32.cu", "gpt2vl_flash_dt_bwd_f32")])
def test_fp32_pair_is_ffma_only(name, entry):
    """The fp32 kernels, the self-attention pair, the general pair, the
    split lse forward and the dt-layout pair, keep every product an fp32 FFMA: no tensor-core instruction (wgmma, mma,
    wmma: TF32 would keep 10 bits of the operands' 23) and no atomics (dq,
    dk, dv bit-equal run to run); their swept tiles arrive by cp.async
    through csrc/flash_f32.cuh, and each kernel states its resident blocks in
    __launch_bounds__."""
    text = (_build.CSRC / name).read_text()
    header = (_build.CSRC / "flash_f32.cuh").read_text()
    assert f'extern "C" int {entry}(' in text and f'extern "C" int {entry}_warps_per_sm(' in text
    assert "load_tile_async<THREADS>" in header and "cp.async.cg.shared.global" in header
    assert "__launch_bounds__(THREADS, MIN_BLOCKS)" in text
    for body in (text, header):
        for gone in (r"wgmma", r"mma\.sync", r"wmma", r"atomic[A-Z]", r"\batom\.", r"\bred\.",
                     r"tf32"):
            assert not re.search(gone, body), (name, gone)


@pytest.mark.parametrize("name,instance", [
    ("flash_fwd_f32.cu", "forward_block<Case::SELF>("),
    ("flash_general_fwd_f32.cu", "forward_block<Case::GENERAL>("),
    ("flash_dt_fwd_f32.cu", "forward_block<Case::DT, true>("),
    ("flash_bwd_f32.cu", "backward_grid<Case::SELF>("),
    ("flash_general_bwd_f32.cu", "pair_grid<Case::GENERAL>("),
    ("flash_lse_fwd_f32.cu", "forward_block<Case::GENERAL, true>("),
    ("flash_dt_bwd_f32.cu", "pair_grid<Case::DT>(")])
def test_fp32_blocks_are_written_once(name, instance):
    """The fp32 forward block, the backward grid (its dk/dv and dq blocks)
    and the one-pass grid (five products a visible pair, dq added in a fixed
    order) are written once, in csrc/flash_f32.cuh, with the case a
    compile-time parameter: the self-attention kernels instance the forward
    block and the backward grid (its only user) with Case::SELF, the A/B
    tool's dt-layout ones (the transposed layout, no offset) the forward
    block split over the key range (its second kernel the merge of the
    parts) and the one-pass grid with Case::DT, the general forward (Tq !=
    Tk, the right-aligned causal offset) the forward block with
    Case::GENERAL, the lse forward the same block split over the key range
    (its second kernel the merge of the parts), and the general backward the
    one-pass grid with Case::GENERAL; no backward but the self one runs the
    dq or the dk/dv block, and no source repeats their products. The
    fp32 D kernel stays in flash_bwd_f32.cu, whose C entry point
    gpt2vl_flash_rowdot_f32 gives the general backward its row term."""
    header = (_build.CSRC / "flash_f32.cuh").read_text()
    for body in ("void forward_block(", "void dkv_block(", "void dq_block(",
                 "void backward_grid(", "void pair_block(", "void pair_grid("):
        assert body in header
    text = (_build.CSRC / name).read_text()
    two = ("flash_bwd_f32.cu", "flash_lse_fwd_f32.cu", "flash_dt_fwd_f32.cu")
    assert instance in text and text.count("__global__") == (2 if name in two else 1)
    for product in ("rows_by_keys<", "keys_by_rows(", "acc_keys(", "acc_rows(", "rows_by_rows(",
                    "keys_by_channels(", "rows_by_channels("):
        assert product not in text, (name, product)
    if name in ("flash_general_bwd_f32.cu", "flash_dt_bwd_f32.cu"):
        for block in ("dq_block", "dkv_block", "backward_grid"):
            assert block not in text, (name, block)
    assert ('extern "C" int gpt2vl_flash_rowdot_f32(' in text) == (name == "flash_bwd_f32.cu")
