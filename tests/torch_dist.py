"""Helpers of the port's multi-process tests: the port's worker
(gpt2_vision_language_tpu_torch/tools/dist_worker.py) over gloo on the CPU,
one torch thread a process and a time limit of its own, and the JAX single
device train step the runs are held against."""

import json
import os

import numpy as np
import torch

from gpt2_vision_language_tpu_torch.tools import dist_worker

# each spawning test's limit: a hung collective ends here, not at the run's
TIMEOUT_S = 300
SCHED = dict(max_lr=1e-3, min_lr=1e-4, warmup_steps=2, max_steps=10)
# eps 1e-6: see tests/test_torch_train_step.py (Adam's first steps on grads
# that are rounding noise)
OPT = dict(eps=1e-6)


def run_ranks(job: dict, nprocs: int, tmp_path) -> list:
    """Run ``job`` on ``nprocs`` processes (in this process when 1) and
    return every rank's record."""
    job = dict(job, out=str(tmp_path), device="cpu", threads=1)
    if nprocs == 1:
        return [dist_worker.run_job(job)]
    dist_worker.launch(job, nprocs, timeout=TIMEOUT_S, workdir=str(tmp_path))
    tag = job.get("tag", job["kind"])
    return [json.load(open(os.path.join(tmp_path, f"{tag}_r{r}.json"))) for r in range(nprocs)]


def run_jobs(jobs: list, nprocs: int, tmp_path, tag: str) -> dict:
    """Run the "step" jobs ``jobs`` in turn in one launch of ``nprocs``
    processes; returns each job's tag -> every rank's record."""
    dist_worker.launch({"kind": "jobs", "jobs": jobs, "tag": tag, "out": str(tmp_path),
                        "device": "cpu", "threads": 1}, nprocs, timeout=TIMEOUT_S,
                       workdir=str(tmp_path))
    return {j["tag"]: [json.load(open(os.path.join(tmp_path, f"{j['tag']}_r{r}.json")))
                       for r in range(nprocs)] for j in jobs}


def whole(tmp_path, tag: str) -> dict:
    """Rank 0's whole tensors of a "step" job: before, after, grads."""
    return torch.load(os.path.join(tmp_path, f"{tag}_whole.pt"), weights_only=True)


def jax_steps(arch: dict, rows: np.ndarray, *, layerwise: bool = False, ring_mesh=None,
              state_dtype=None, state_out=None):
    """The JAX single-device train steps over ``rows`` (steps, accum, B,
    T + 1) from the JAX init of ``arch`` at PRNGKey(0), fp32, the moments
    stored as ``state_dtype`` asks (None: fp32). Returns (the initial params,
    each step's metrics, the params after) as numpy trees; ``state_out``
    (a dict) receives the final AdamW state as "state"."""
    import jax
    import jax.numpy as jnp

    from gpt2_vision_language_tpu.core import config as jcfg
    from gpt2_vision_language_tpu.core.precision import FP32_POLICY
    from gpt2_vision_language_tpu.models import gpt2 as jgpt2
    from gpt2_vision_language_tpu.ops import ring_attention as jra
    from gpt2_vision_language_tpu.train import make_train_step
    from gpt2_vision_language_tpu.train.optimizer import adamw_init

    jc = jcfg.GPTConfig(**arch)
    params = jgpt2.init(jax.random.PRNGKey(0), jc)
    p0 = jax.tree.map(np.asarray, params)
    impl = "xla" if ring_mesh is None else "ring"

    def loss(p, micro):
        r = micro["rows"]
        return jgpt2.loss(p, r[:, :-1], jc, targets=r[:, 1:], policy=FP32_POLICY,
                          attn_impl=impl)

    lw = None
    if layerwise:
        def lw(p, micro, gsum, acc):
            r = micro["rows"]
            return jgpt2.loss_grad_layerwise(p, r[:, :-1], jc, targets=r[:, 1:], gsum=gsum,
                                             acc=acc, policy=FP32_POLICY, ce_chunks=2)

    step = make_train_step(loss, jcfg.OptimizerConfig(**OPT), jcfg.ScheduleConfig(**SCHED),
                           decay_mask=jgpt2.decay_mask(params), donate=False,
                           layerwise_loss_grad=lw)
    state = adamw_init(params, state_dtype=None if state_dtype is None else jnp.dtype(state_dtype))
    metrics = []
    if ring_mesh is not None:
        jra.set_ring_mesh(ring_mesh)
    try:
        for i in range(rows.shape[0]):
            params, state, m = step(params, state, {"rows": jnp.asarray(rows[i])},
                                    jnp.int32(i))
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        if ring_mesh is not None:
            jra.set_ring_mesh(None)
    if state_out is not None:
        state_out["state"] = jax.tree.map(np.asarray, state)
    return p0, metrics, jax.tree.map(np.asarray, params)


def port_init(p0, arch: dict, path) -> str:
    """The JAX init as a port state dict file (the workers' ``init``)."""
    from gpt2_vision_language_tpu_torch.ckpt.convert import gpt2_from_jax_params
    from gpt2_vision_language_tpu_torch.core.config import GPTConfig
    from gpt2_vision_language_tpu_torch.models import gpt2

    cfg = GPTConfig(**arch)
    model = gpt2.GPT2(cfg)
    model.load_state_dict(gpt2_from_jax_params(p0, cfg))
    torch.save(model.state_dict(), str(path))
    return str(path)


def assert_matches_jax(rec: dict, after: dict, jax_metrics: list, jax_after, arch: dict,
                       what: str) -> None:
    """A port run's metrics and whole params after its steps against the JAX
    steps': loss and grad norm within 1e-5 relative, params within rtol
    1e-4, atol 1e-5 (the JAX package's own TP tolerances)."""
    from gpt2_vision_language_tpu_torch.ckpt.convert import gpt2_from_jax_params
    from gpt2_vision_language_tpu_torch.core.config import GPTConfig

    for i, (m, jm) in enumerate(zip(rec["metrics"], jax_metrics)):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(m[key], jm[key], rtol=1e-5, err_msg=f"{what} {i} {key}")
    want = gpt2_from_jax_params(jax_after, GPTConfig(**arch))
    for n, t in after.items():
        np.testing.assert_allclose(t.numpy(), want[n].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=f"{what} {n}")


def a2a_rank(out_dir: str, n_head: int) -> None:
    """One rank of the all-to-all round trip (launched by ``run_a2a``):
    (B, T, 3, heads[r], hs) slices of one seeded (B, T, 3, n_head, hs)
    tensor through ``HeadsToChunks`` and ``ChunksToHeads``, in fp32 and bf16,
    and the gradient of each; writes what it checked to
    ``{out_dir}/a2a_r{rank}.json``."""
    import torch.distributed as dist

    from gpt2_vision_language_tpu_torch.parallel import collectives as coll
    from gpt2_vision_language_tpu_torch.parallel.mesh import maybe_init_distributed
    from gpt2_vision_language_tpu_torch.parallel.sharding import split_counts

    maybe_init_distributed("gloo")
    torch.set_num_threads(1)
    group, r, n = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    heads = split_counts(n_head, n)
    h0, tc = sum(heads[:r]), 8 // n
    g = torch.Generator().manual_seed(0)
    full = torch.randn(2, 8, 3, n_head, 4, generator=g)
    weight = torch.randn(2, 8, 3, n_head, 4, generator=g)
    x = full[..., h0:h0 + heads[r], :].clone().requires_grad_(True)
    chunk = coll.HeadsToChunks.apply(x, group, heads)
    assert torch.equal(chunk, full[:, r * tc:(r + 1) * tc]), "heads -> chunks"
    # d/dx of sum(weight's chunk * chunk) is weight at this rank's heads
    (chunk * weight[:, r * tc:(r + 1) * tc]).sum().backward()
    assert torch.equal(x.grad, weight[..., h0:h0 + heads[r], :]), "HeadsToChunks backward"
    y = chunk.detach().requires_grad_(True)
    back = coll.ChunksToHeads.apply(y, group, heads)
    assert torch.equal(back, x.detach()), "chunks -> heads"
    (back * weight[..., h0:h0 + heads[r], :]).sum().backward()
    assert torch.equal(y.grad, weight[:, r * tc:(r + 1) * tc]), "ChunksToHeads backward"
    xb = x.detach().to(torch.bfloat16)
    cb = coll.heads_to_chunks(xb, group, heads)
    assert cb.dtype == torch.bfloat16 and torch.equal(cb, full[:, r * tc:(r + 1) * tc].bfloat16())
    assert torch.equal(coll.chunks_to_heads(cb, group, heads), xb), "bf16 round trip"
    with open(os.path.join(out_dir, f"a2a_r{r}.json"), "w") as f:
        json.dump({"heads": heads, "chunk_shape": list(chunk.shape),
                   "all_to_all": coll.counts["all_to_all"]}, f)
    dist.barrier()
    dist.destroy_process_group()


def run_a2a(nprocs: int, n_head: int, tmp_path) -> list:
    """``a2a_rank`` on ``nprocs`` gloo processes; every rank's record."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = (f"import sys; sys.path.insert(0, {here!r}); import torch_dist; "
            f"torch_dist.a2a_rank({str(tmp_path)!r}, {n_head})")
    dist_worker.launch({"tag": "a2a"}, nprocs, timeout=TIMEOUT_S, workdir=str(tmp_path),
                       argv=["-c", code])
    return [json.load(open(os.path.join(tmp_path, f"a2a_r{r}.json"))) for r in range(nprocs)]
