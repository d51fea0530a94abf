"""The port's ring attention against the JAX package's on the 8-device CPU
mesh (the same numpy inputs through both), against plain attention at every
ring size, through GPT-2, and its process-group ring over gloo against its
one-process ring."""

import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_vision_language_tpu.core.config import GPTConfig as JaxGPTConfig
from gpt2_vision_language_tpu.core.precision import FP32_POLICY as JAX_FP32
from gpt2_vision_language_tpu.models import gpt2 as jax_gpt2
from gpt2_vision_language_tpu.ops import ring_attention as jra
from gpt2_vision_language_tpu.parallel.mesh import make_mesh
from gpt2_vision_language_tpu_torch.ckpt.convert import gpt2_from_jax_params
from gpt2_vision_language_tpu_torch.core.config import GPTConfig
from gpt2_vision_language_tpu_torch.core.precision import FP32_POLICY
from gpt2_vision_language_tpu_torch.models import gpt2
from gpt2_vision_language_tpu_torch.ops import attention
from gpt2_vision_language_tpu_torch.ops import flash_attention as fa
from gpt2_vision_language_tpu_torch.ops import ring_attention as ra
from torch_threads import share_cores  # noqa: F401  (autouse)


def _qkvw(b, h, t, hs, seed):
    """q, k, v and an output cotangent, (B, H, T, hs) fp32 as the JAX function
    takes them."""
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((b, h, t, hs)).astype(np.float32) for _ in range(4)]


def _port_ring(q, k, v, w, ring, chunk_impl, layout="bhtd"):
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = ra.ring_attention(q, k, v, ring, chunk_impl=chunk_impl, layout=layout)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach(), (q.grad, k.grad, v.grad)


@pytest.mark.parametrize(
    "chunk_impl, shape, grad_tol",
    [("einsum", (2, 2, 32, 16), dict(rtol=5e-5, atol=5e-5)),
     ("flash", (2, 2, 512, 64), dict(rtol=5e-4, atol=5e-5))],
)
def test_ring_matches_jax_ring(chunk_impl, shape, grad_tol):
    """Values and gradients of the one-process ring of 4 against the JAX
    ring_attention over the "model" axis of the (2, 4) mesh; the flash chunks
    run the Pallas kernels in interpret mode there and the plain versions of
    the CUDA kernels here. Tolerances of tests/test_ring_attention.py."""
    assert jax.device_count() >= 8
    mesh = make_mesh(8, ("data", "model"), shape=(2, 4))
    q, k, v, w = _qkvw(*shape, seed=4)

    def loss(q, k, v):
        out = jra.ring_attention(q, k, v, mesh, axis_name="model", chunk_impl=chunk_impl,
                                 interpret=True)
        return jnp.sum(out * w), out

    (_, want), want_g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *map(jnp.asarray, (q, k, v)))
    got, got_g = _port_ring(q, k, v, w, 4, chunk_impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    for g, r, name in zip(got_g, want_g, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=f"d{name}", **grad_tol)
    assert fa.flash_lse_forward.launches == 0 and fa.flash_fused_backward.launches == 0


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("chunk_impl", ["einsum", "flash"])
def test_ring_sizes_match_plain_attention(n, chunk_impl):
    hs = 64 if chunk_impl == "flash" else 16
    q, k, v, w = _qkvw(2, 2, 64, hs, seed=n)
    got, got_g = _port_ring(q, k, v, w, ra.LocalRing(n), chunk_impl)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    want = attention.xla_sdpa(qt, kt, vt, causal=True)
    (want * torch.from_numpy(w)).sum().backward()
    torch.testing.assert_close(got, want.detach(), rtol=2e-5, atol=2e-5)
    for g, r in zip(got_g, (qt.grad, kt.grad, vt.grad)):
        torch.testing.assert_close(g, r, rtol=5e-4, atol=5e-5)
    # the port's own layout gives the same numbers
    bthd = [np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v, w)]
    got2, _ = _port_ring(*bthd, n, chunk_impl, layout="bthd")
    torch.testing.assert_close(got2.transpose(1, 2), got)


def test_ring_arguments():
    q, k, v, _ = map(torch.from_numpy, _qkvw(1, 2, 30, 16, seed=0))
    with pytest.raises(ValueError, match="non-causal"):
        ra.ring_attention(q, k, v, 2, causal=False, layout="bhtd")
    with pytest.raises(ValueError, match="not divisible"):
        ra.ring_attention(q, k, v, 4, layout="bhtd")
    with pytest.raises(ValueError, match="chunk_impl"):
        ra.ring_attention(q, k, v, 2, chunk_impl="bogus", layout="bhtd")
    with pytest.raises(ValueError, match="at least 1"):
        ra.LocalRing(0)
    # "auto" on CPU tensors is the einsum chunk
    a = ra.ring_attention(q, k, v, 2, layout="bhtd")
    b = ra.ring_attention(q, k, v, 2, chunk_impl="einsum", layout="bhtd")
    assert torch.equal(a, b)


def test_merge_with_empty_carry_has_no_nan():
    """A carry that has seen no key (out 0, lse NEG_INF) merges to the update
    itself, with finite gradients; two such partials merge to zeros, not NaN;
    and _merge equals the JAX one."""
    rng = np.random.RandomState(0)
    o1 = rng.standard_normal((1, 8, 2, 4)).astype(np.float32)
    l1 = rng.standard_normal((1, 8, 2, 1)).astype(np.float32)
    o0, l0 = np.zeros_like(o1), np.full_like(l1, ra.NEG_INF)
    assert ra.NEG_INF == jra.NEG_INF
    ot, lt = torch.from_numpy(o1).requires_grad_(True), torch.from_numpy(l1).requires_grad_(True)
    c0 = torch.from_numpy(o0).requires_grad_(True)
    cl = torch.from_numpy(l0).requires_grad_(True)
    out, lse = ra._merge((c0, cl), (ot, lt))
    assert torch.equal(out, ot) and torch.equal(lse, lt)
    (out.sum() + lse.sum()).backward()
    for g in (ot.grad, lt.grad, c0.grad, cl.grad):
        assert torch.isfinite(g).all()
    both, lboth = ra._merge((c0, cl), (c0, cl))
    assert torch.isfinite(both).all() and (both == 0).all() and torch.isfinite(lboth).all()
    # two real partials against the JAX merge
    o2 = rng.standard_normal(o1.shape).astype(np.float32)
    l2 = rng.standard_normal(l1.shape).astype(np.float32)
    want = jra._merge((jnp.asarray(o1), jnp.asarray(l1)), (jnp.asarray(o2), jnp.asarray(l2)))
    got = ra._merge(tuple(map(torch.from_numpy, (o1, l1))), tuple(map(torch.from_numpy, (o2, l2))))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


def test_chunk_attn_einsum_matches_jax():
    q, k, v, _ = _qkvw(1, 2, 24, 16, seed=3)
    k, v = k[:, :, :16], v[:, :, :16]
    for causal in (True, False):
        qq = q[:, :, :16] if causal else q  # Tq == Tk causal, Tq > Tk without a mask
        want_o, want_l = jra._chunk_attn_einsum(*map(jnp.asarray, (qq, k, v)), causal=causal,
                                                scale=0.25)
        got_o, got_l = ra._chunk_attn_einsum(
            *(torch.from_numpy(a).transpose(1, 2) for a in (qq, k, v)), causal=causal,
            scale=0.25)
        np.testing.assert_allclose(got_o.transpose(1, 2).numpy(), np.asarray(want_o),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got_l.transpose(1, 2).numpy(), np.asarray(want_l),
                                   rtol=2e-5, atol=2e-5)


def test_gpt2_loss_with_ring_attn_impl():
    """attn_impl="ring" end to end through the decoder (2 layers, width 32,
    T = 16, a ring of 4): the loss against the JAX gpt2.apply(attn_impl="ring")
    on the (2, 4) mesh with the same weights, and against the port's "xla"."""
    assert jax.device_count() >= 8
    mesh = make_mesh(8, ("data", "model"), shape=(2, 4))
    arch = dict(block_size=16, vocab_size=128, n_layer=2, n_head=2, n_embd=32)
    jcfg, cfg = JaxGPTConfig(**arch), GPTConfig(**arch)
    params = jax_gpt2.init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(1)
    x = rng.randint(0, 128, (4, 16))
    y = np.roll(x, -1, axis=-1)
    jra.set_ring_mesh(mesh)
    try:
        _, want = jax.jit(lambda p, x, y: jax_gpt2.apply(
            p, x, jcfg, targets=y, policy=JAX_FP32, attn_impl="ring"))(
                params, jnp.asarray(x), jnp.asarray(y))
    finally:
        jra.set_ring_mesh(None)
    model = gpt2.GPT2(cfg)
    model.load_state_dict(gpt2_from_jax_params(jax.tree.map(np.asarray, params), cfg))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    plain = gpt2.loss(model, xt, cfg, targets=yt, policy=FP32_POLICY, attn_impl="xla")
    ra.set_ring(4)
    try:
        got = gpt2.loss(model, xt, cfg, targets=yt, policy=FP32_POLICY, attn_impl="ring")
        got.backward()
    finally:
        ra.set_ring(None)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(got.item(), plain.item(), rtol=1e-5)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_sdpa_ring_needs_a_ring():
    q, k, v, _ = map(torch.from_numpy, _qkvw(1, 2, 16, 16, seed=0))
    assert ra.RING is None
    with pytest.raises(RuntimeError, match="set_ring"):
        attention.sdpa(q, k, v, causal=True, impl="ring")
    ra.set_ring(ra.LocalRing(2))
    try:
        got = attention.sdpa(q, k, v, causal=True, impl="ring")
    finally:
        ra.set_ring(None)
    torch.testing.assert_close(got, attention.xla_sdpa(q, k, v, causal=True),
                               rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# The process-group ring: one process per rank over gloo
# ---------------------------------------------------------------------------

GROUP_TIMEOUT_S = 120


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _group_worker(rank, world, port, chunk_impl, out_dir):
    """One rank: its chunk through ring_attention over the group, values and
    q/k/v gradients against the one-process ring's on the global tensors."""
    import datetime

    import torch.distributed as dist

    from gpt2_vision_language_tpu_torch.parallel import mesh as pmesh

    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        pmesh.maybe_init_distributed()  # already joined: a no-op
        assert pmesh.is_master() == (rank == 0)
        ring = pmesh.ring_from_group()
        assert (ring.rank, ring.size) == (rank, world)
        hs = 64 if chunk_impl == "flash" else 16
        q, k, v, w = (np.ascontiguousarray(a.transpose(0, 2, 1, 3))
                      for a in _qkvw(2, 2, 16 * world, hs, seed=11))
        want, want_g = _port_ring(q, k, v, w, world, chunk_impl, layout="bthd")
        cut = slice(rank * 16, (rank + 1) * 16)
        got, got_g = _port_ring(*(np.ascontiguousarray(a[:, cut]) for a in (q, k, v, w)),
                                ring, chunk_impl, layout="bthd")
        torch.testing.assert_close(got, want[:, cut], rtol=1e-6, atol=1e-6)
        for g, r, name in zip(got_g, want_g, "qkv"):
            torch.testing.assert_close(g, r[:, cut], rtol=1e-6, atol=1e-6, msg=f"d{name}")
        # under no_grad no rotation's backward is needed or run
        with torch.no_grad():
            again = ra.ring_attention(*(torch.from_numpy(np.ascontiguousarray(a[:, cut]))
                                        for a in (q, k, v)), ring, chunk_impl=chunk_impl)
        assert torch.equal(again, got)
        dist.barrier()
        open(os.path.join(out_dir, f"ok{rank}"), "w").close()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world, chunk_impl", [(2, "einsum"), (4, "einsum"), (4, "flash")])
def test_group_ring_matches_local_ring(tmp_path, world, chunk_impl):
    """2 and 4 processes over gloo on CPU tensors: every rank's output chunk
    and its q/k/v gradients equal the one-process ring's within 1e-6. A
    deadlock ends at the group's own timeout and at the join's."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_group_worker, args=(world, _free_port(), chunk_impl, str(tmp_path)),
                             nprocs=world, join=False, start_method="spawn")
    try:
        deadline = GROUP_TIMEOUT_S + 60
        while not ctx.join(timeout=5):
            deadline -= 5
            assert deadline > 0, "the ring over the process group did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    assert sorted(os.listdir(tmp_path)) == [f"ok{r}" for r in range(world)]
