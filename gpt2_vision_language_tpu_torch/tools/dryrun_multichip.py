"""The parallel styles at tiny shapes over N processes, one line out.

    python -m gpt2_vision_language_tpu_torch.tools.dryrun_multichip N [--device cpu|cuda:0|cuda]

Counterpart of the JAX package's ``dryrun_multichip`` (__graft_entry__.py:43):
N gloo processes (``tools/dist_worker.launch``; ``--device cuda:0`` puts
them all on one card, ``cuda``, the default, gives each rank a card of its
own over NCCL, ``cpu`` asks for the CPU) run, at the JAX run's shapes
(GPT-2 of block_size 64, vocab 512, 2 layers, 6 heads, width 192;
accumulation 2, B = 2N, T = 32):

  * one train step of data x Megatron TP x sequence parallelism on a
    (2, N / 2) mesh when N is even and at least 4 (6 heads over N / 2 ranks:
    unevenly where they must), data parallelism over N otherwise;
  * on that mesh, the ring over the model group inside the Megatron-sharded
    attention, with sequence parallelism, from the updated weights: its
    step's loss within 5e-3 of the plain loss at those weights;
  * the GPipe pipeline over min(N, n_layer) stages (a ("data", "pipe")
    mesh): the blocks' forward within 1e-4 of ``run_blocks`` under fp32, and
    a pipelined train step whose loss is within 5e-3 of the plain one.

Rank 0 prints ``dryrun_multichip(N): ok — loss ..., grad_norm ..., mesh
..., ring step loss ..., pp(S stages) err ... step loss ...``, in the JAX
wording, and this process prints it again; a failed check fails the run.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch

CFG = dict(block_size=64, vocab_size=512, n_layer=2, n_head=6, n_embd=192)
SCHED = dict(max_lr=1e-3, min_lr=1e-4, warmup_steps=2, max_steps=10)
TIMEOUT_S = 600


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def run_rank(n_devices: int, device: str) -> str:
    """This rank's part of the dry run; returns the ok line."""
    import torch.distributed as dist

    from ..core.config import GPTConfig, OptimizerConfig, ScheduleConfig
    from ..core.precision import DEFAULT_POLICY, FP32_POLICY
    from ..models import gpt2
    from ..parallel.mesh import init_distributed, make_mesh
    from ..parallel.pipeline import make_pipeline_loss_fn, pipeline_run_blocks
    from ..parallel.sharding import setup_parallel
    from ..train.optimizer import adamw_init
    from ..train.step import make_eval_step, make_train_step

    dev = init_distributed(device)
    torch.set_num_threads(1)
    cfg = GPTConfig(**CFG)
    accum, b, t = 2, 2 * n_devices, 32
    rng = np.random.RandomState(0)
    x = rng.randint(0, cfg.vocab_size, (accum, b, t))
    y = np.roll(x, -1, axis=-1)
    two_d = n_devices % 2 == 0 and n_devices >= 4
    if two_d:
        mesh = make_mesh(n_devices, ("data", "model"), (2, n_devices // 2))
    else:
        mesh = make_mesh(n_devices, ("data",))

    def rows_of(m):
        """This data rank's rows of the global batch."""
        d, n = m.coord("data"), m.size("data")
        cut = slice(d * b // n, (d + 1) * b // n)
        return {k: torch.from_numpy(np.ascontiguousarray(a[:, cut])).to(dev)
                for k, a in (("x", x), ("y", y))}

    def step_of(model, loss_fn, sync, placement=None, layerwise=None):
        return make_train_step(loss_fn, OptimizerConfig(), ScheduleConfig(**SCHED),
                               decay_mask=gpt2.decay_mask(model), grad_sync=sync,
                               placement=placement, layerwise_loss_grad=layerwise)

    # data x model x sequence parallelism
    model = gpt2.init(cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
    placement, sync = setup_parallel(model, mesh, seq_parallel=two_d)

    def loss_fn(m, micro):
        return gpt2.loss(m, micro["x"], cfg, targets=micro["y"], policy=DEFAULT_POLICY)

    state = adamw_init(gpt2.named_params(model), placement=placement)
    batch = rows_of(mesh)
    metrics = step_of(model, loss_fn, sync, placement)(model, state, batch, 0)
    loss = metrics["loss"]
    _check(np.isfinite(loss), f"loss {loss}")
    # the plain loss at the updated weights, the comparator of the pins below
    post = make_eval_step(loss_fn)(model, batch)
    post = float(post if sync is None else sync.mean_loss(post))
    whole = {n: p.detach().clone() for n, p in
             placement.whole(dict(gpt2.named_params(model))).items()}

    def whole_model():
        m = gpt2.GPT2(cfg).to(dev)
        with torch.no_grad():
            for n, p in gpt2.named_params(m).items():
                p.copy_(whole[n])
        return m

    ring_note = ""
    if two_d and t % mesh.size("model") == 0:
        # the ring over the model group inside Megatron-sharded attention,
        # with sequence parallelism, as JAX runs attn_impl="ring" under tp
        rmodel = whole_model()
        rplace, rsync = setup_parallel(rmodel, mesh, seq_parallel=True)

        def ring_loss(m, micro):
            return gpt2.loss(m, micro["x"], cfg, targets=micro["y"], policy=DEFAULT_POLICY,
                             attn_impl="ring")

        rm = step_of(rmodel, ring_loss, rsync, rplace)(
            rmodel, adamw_init(gpt2.named_params(rmodel), placement=rplace), batch, 0)
        _check(np.isfinite(rm["loss"]), f"ring loss {rm['loss']}")
        _check(abs(rm["loss"] - post) < 5e-3, f"ring step loss {rm['loss']} vs {post}")
        ring_note = f", ring step loss {rm['loss']:.4f}"

    pp_note = ""
    n_stage = min(n_devices, cfg.n_layer)
    if n_devices >= 2 and cfg.n_layer % n_stage == 0 and n_devices % n_stage == 0:
        pmesh = make_mesh(n_devices, ("data", "pipe"), (n_devices // n_stage, n_stage))
        emb = torch.from_numpy(np.random.RandomState(1).randn(4, t, cfg.n_embd)
                               .astype(np.float32)).to(dev)
        with torch.no_grad():
            ref = gpt2.run_blocks(whole_model(), emb, cfg, policy=FP32_POLICY, attn_impl="xla")
        pmodel = whole_model()
        pplace, psync = setup_parallel(pmodel, pmesh)
        got = pipeline_run_blocks(pmodel, emb, cfg, n_micro=2, policy=FP32_POLICY,
                                  attn_impl="xla")
        err = float((got - ref).abs().max())
        _check(err < 1e-4, f"pipeline mismatch {err}")
        pipe = make_pipeline_loss_fn(cfg, pmesh, n_micro=2, policy=FP32_POLICY)
        pm = step_of(pmodel, pipe.loss, psync, pplace, pipe.loss_grad)(
            pmodel, adamw_init(gpt2.named_params(pmodel), placement=pplace), rows_of(pmesh), 0)
        _check(np.isfinite(pm["loss"]), f"pp loss {pm['loss']}")
        _check(abs(pm["loss"] - post) < 5e-3, f"pp step loss {pm['loss']} vs {post}")
        pp_note = f", pp({n_stage} stages) err {err:.2e} step loss {pm['loss']:.4f}"

    line = (f"dryrun_multichip({n_devices}): ok — loss {loss:.4f}, "
            f"grad_norm {metrics['grad_norm']:.4f}, mesh {mesh}{ring_note}{pp_note}")
    if dist.get_rank() == 0:
        print(line, flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return line


def dryrun_multichip(n_devices: int, device: str = "cuda", *,
                     timeout: float = TIMEOUT_S) -> str:
    """Run the dry run over ``n_devices`` processes (each killed at
    ``timeout`` seconds); returns rank 0's ok line."""
    from . import dist_worker

    args = ["-m", "gpt2_vision_language_tpu_torch.tools.dryrun_multichip", str(n_devices),
            "--device", device, "--rank"]
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        logs = dist_worker.launch({"tag": "dryrun"}, n_devices, timeout=timeout, workdir=tmp,
                                  argv=args)
    ok = [ln for ln in logs[0].splitlines() if ln.startswith("dryrun_multichip(")]
    if not ok:
        raise RuntimeError("rank 0 printed no result:\n" + logs[0][-4000:])
    return ok[-1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_devices", type=int)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (a card a rank, NCCL), 'cuda:N' (every rank on card N, "
                   "gloo) or 'cpu'")
    p.add_argument("--rank", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank:  # one process of the run (launched by dryrun_multichip)
        run_rank(args.n_devices, args.device)
        return 0
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("dryrun_multichip: no CUDA device (torch.cuda.is_available() is False); pass "
              "--device cpu to run on the CPU", file=sys.stderr)
        return 2
    print(dryrun_multichip(args.n_devices, args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
