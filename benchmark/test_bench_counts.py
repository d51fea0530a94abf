"""The yardstick's arithmetic: FLOPs per token, attention and product work,
and the reduction of a trace to busy time, gaps and classes."""

import pytest

from harness import kernel_classes, manifest, trace


def _metric(name):
    return manifest.load_module("metrics", name)


@pytest.mark.parametrize("config,seq_len,want", [
    # 6 x (12 x 12 x 768^2 + 50304 x 768) + 6 x 12 x 1024 x 768
    ("gpt2-124m", 1024, 6 * (12 * 12 * 768 ** 2 + 50304 * 768) + 6 * 12 * 1024 * 768),
    ("gpt2-124m", 16384, 6 * (12 * 12 * 768 ** 2 + 50304 * 768) + 6 * 12 * 16384 * 768),
    # 6 x (48 x 12 x 1600^2 + 50304 x 1600) + 6 x 48 x 1024 x 1600
    ("gpt2-1558m", 1024, 6 * (48 * 12 * 1600 ** 2 + 50304 * 1600) + 6 * 48 * 1024 * 1600),
])
def test_step_mfu_flops_per_token(config, seq_len, want):
    cfg = manifest.config(manifest.load_manifest(), config)
    got = _metric("step_mfu").flops_per_token(cfg["n_layer"], cfg["n_embd"],
                                              cfg["assumed"]["padded_vocab_size"], seq_len)
    assert got == want


def test_step_mfu_reads_the_window():
    from types import SimpleNamespace

    run = SimpleNamespace(
        dims={"n_layer": 12, "n_embd": 768, "vocab_pad": 50304}, traffic={"seq_len": 1024},
        window={"tokens": 1000, "seconds": 1.0}, compute="bf16",
        peaks={"flops": {"bf16": 989e12}, "bytes_per_s": 3.35e12})
    per_token = 6 * (12 * 12 * 768 ** 2 + 50304 * 768) + 6 * 12 * 1024 * 768
    assert _metric("step_mfu").read(run) == pytest.approx(100 * per_token * 1000 / 989e12)
    run.peaks = None
    assert _metric("step_mfu").read(run) is None


def test_attention_work():
    fwd = _metric("attn_fwd_roofline").forward_work(2, 12, 1024, 64, 2)
    bwd = _metric("attn_bwd_roofline").backward_work(2, 12, 1024, 64, 2)
    assert fwd[0] == 2 * 2 * 12 * 1024 ** 2 * 64  # 2 products x 2 x ... / 2 (causal)
    assert bwd[0] == 2 * fwd[0]  # 4 products
    assert fwd[1] == 4 * 2 * 1024 * 12 * 64 * 2 + 4 * 2 * 12 * 1024
    assert bwd[1] == 8 * 2 * 1024 * 12 * 64 * 2 + 4 * 2 * 12 * 1024


def test_mm_work():
    mm = _metric("gemm_roofline").mm_work
    assert mm([[8, 3], [3, 5]]) == (2 * 8 * 5 * 3, 8 * 3 + 3 * 5 + 8 * 5)
    assert mm([[8, 5], [8, 3], [3, 5]]) == (2 * 8 * 5 * 3, 8 * 3 + 3 * 5 + 8 * 5)
    assert mm([[4, 8, 3], [4, 3, 5]]) == (2 * 4 * 8 * 5 * 3, 4 * (8 * 3 + 3 * 5 + 8 * 5))
    with pytest.raises(ValueError):
        mm([[8, 3], [4, 5]])


def test_gemm_roofline_reads_ops():
    from types import SimpleNamespace

    ops = [{"name": "aten::mm", "shapes": [[4096, 4096], [4096, 4096]], "count": 2,
            "device_us": 1000.0}]
    run = SimpleNamespace(trace={"mm_ops": ops}, compute="bf16",
                          peaks={"flops": {"bf16": 1e15}, "bytes_per_s": 1e12})
    want = 100 * 2 * max(2 * 4096 ** 3 / 1e15, 3 * 4096 ** 2 * 2 / 1e12) / 1e-3
    assert _metric("gemm_roofline").read(run) == pytest.approx(want)


def test_merge_and_gaps():
    merged = trace.merge([(5, 7), (0, 2), (1, 3), (6, 9)])
    assert merged == [[0, 3], [5, 9]]
    assert trace.gaps(merged, -1, 12) == [(-1, 0), (3, 5), (9, 12)]
    assert trace.clip([(0, 4), (5, 20)], 2, 10) == [(2, 4), (5, 10)]


def _events():
    x = lambda name, cat, ts, dur, tid=1: {"ph": "X", "name": name, "cat": cat,  # noqa: E731
                                           "ts": ts, "dur": dur, "tid": tid}
    return [
        x("bench.window", "user_annotation", 0, 100),
        x("bench.window", "gpu_user_annotation", 0, 100, tid=7),
        x("bench.train_step", "user_annotation", 10, 80),
        x("aten::mm", "cpu_op", 10, 5),
        x("aten::_local_scalar_dense", "cpu_op", 40, 30),
        x("aten::copy_", "cpu_op", 42, 1, tid=2),
        x("sm90_xmma_gemm_bf16", "kernel", 12, 20, tid=7),
        x("void at::native::vectorized_elementwise_kernel<4>", "kernel", 30, 10, tid=7),
        x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 70, 10, tid=8),
        x("flash_fwd_kernel", "kernel", 95, 10, tid=7),
    ]


def test_reduce_device():
    events = [e for e in _events() if e["cat"] in ("kernel", "gpu_memcpy")]
    r = trace.reduce_device(events, 1)
    # the first and last events bound the span: 12-105; busy 12-40, 70-80, 95-105
    assert r["window_us"] == 93
    assert r["busy_us"] == 28 + 10 + 10
    assert r["by_name"]["flash_fwd_kernel"] == 10
    cls = kernel_classes.by_class(r["by_name"])
    assert cls == {"GEMM": 20, "elementwise": 10, "memcpy/memset": 10,
                   "self-attention flash forward": 10}
    run = type("R", (), {"trace": r})
    assert _metric("device_idle_share").read(run) == pytest.approx(100 * (1 - 48 / 93))
    assert _metric("glue_share").read(run) == pytest.approx(100 * 20 / 50)


def test_reduce_host():
    # inside the window span 0-100: busy 12-40, 70-80, 95-100
    assert trace.reduce_host(_events()) == [
        ("bench.train_step > aten::_local_scalar_dense", 30),
        ("bench.train_step", 15),
        ("outside the benchmark's spans > bench.window", 12)]


@pytest.mark.parametrize("name,cls", [
    ("flash_general_bwd_f32_kernel<true>", "general flash backward fp32"),
    ("void rowdot_f32_kernel<64>", "flash D pre-kernel"),
    ("flash_rowdot_kernel", "flash D pre-kernel"),
    ("flash_fwd_f32_kernel", "self-attention flash forward"),
    ("flash_general_fwd_f32_kernel", "general flash forward"),
    ("flash_lse_merge_f32_kernel", "lse flash merge"),
    ("nvjet_tst_128x256", "GEMM"),
    ("void at::native::reduce_kernel<512, 1>", "reduction"),
    ("CatArrayBatchedCopy", "other"),
])
def test_classes(name, cls):
    assert kernel_classes.classify(name) == cls


def test_attention_classes_cover_the_flash_kernels():
    """Every flash kernel of the program's sources falls in exactly one of the
    attention rooflines' classes (the CE and AdamW kernels in neither)."""
    import re
    from pathlib import Path

    fwd = _metric("attn_fwd_roofline").FORWARD
    bwd = _metric("attn_bwd_roofline").BACKWARD
    csrc = Path(manifest.ROOT) / "gpt2_vision_language_tpu_torch" / "csrc"
    names = set()
    for src in csrc.glob("*.cu*"):
        names |= set(re.findall(r"\b(flash_\w+_kernel|rowdot\w*_kernel)\b", src.read_text()))
    assert names
    for n in names:
        hits = [any(f in n for f in fwd), any(f in n for f in bwd)]
        assert sum(hits) == 1, n
