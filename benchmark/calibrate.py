"""Read the numbers that the limits of a cell are set from, on the chip.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds ...] [--faults half_batch,...] [--fault-seeds ...] \
        [--out chiprun_out/calibrate.jsonl]

For each of ``--seeds``: the program's sound run of the cell (its set-up and
checked steps, a window of one step, the reference after it) and the numbers
the comparison takes, as a run prints them. For each of ``--control-seeds``:
the control, the plain reference computed one precision below what the
cell's traffic states (fp8 products for bf16, TF32 for fp32), put in the
program's place and compared with the fp32 reference. For each fault of
``--faults`` and seed of ``--fault-seeds``: the program's run with that fault
planted (``benchmark/faults.py``). One JSON line a reading, to standard
output and to ``--out``. The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
for _p in (str(BENCH.parent), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

import faults  # noqa: E402
from harness import compare, traffic as gen, weights as seeded  # noqa: E402
from reference import gpt2 as reference  # noqa: E402
from run import prepare  # noqa: E402

CONTROL = {"bf16": "fp8", "fp32": "tf32"}


def sound(prep, seed: int, device) -> dict:
    ctx = SimpleNamespace(config=prep.config, traffic=prep.traffic, seed=seed, seconds=0.0,
                          trace=False, device=device, t_start=time.perf_counter())
    rec = prep.driver.run(ctx)
    out = compare.readings(rec.program, rec.reference)
    out.update(setup_s=rec.setup_s, reference_s=rec.reference_s, failed=rec.failed,
               loss_program=rec.program["loss"], loss_reference=rec.reference["loss"])
    return out


def control(prep, seed: int, device) -> dict:
    """The reference in the control's precision against the fp32 one, on the
    cell's weights and rows."""
    tr, cfg = prep.traffic, prep.config
    t = tr["seq_len"]
    import tempfile

    with tempfile.TemporaryDirectory(prefix="gpt2-bench-cal-") as tmp:
        paths = gen.write_shards(tmp, tr["tokens"], seed)
        rows = gen.step_rows(paths, tr["micro_batch_size"], t, tr["grad_accum_steps"],
                             int(tr["checked_steps"]))
    dims = seeded.dims(cfg, t)
    args = (rows, dims, tr["optimizer"], tr["schedule"])
    kw = {"block_tokens": int(tr["reference_block_tokens"])}
    t0 = time.perf_counter()
    flat, init = seeded.make(cfg, t, seed, device)
    ref = reference.train_steps(init, *args, precision="fp32", **kw)
    low = reference.train_steps(init, *args, precision=CONTROL[tr["policy"]],
                                kept=ref.pop("kept"), **kw)
    del flat, init
    gc.collect()
    out = compare.readings(low, ref)
    out.update(precision=CONTROL[tr["policy"]], seconds=time.perf_counter() - t0,
               loss_program=low["loss"], loss_reference=ref["loss"])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda:0")
    prep = prepare(args.workload, False)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    jobs = [("sound", None, s) for s in ints(args.seeds)]
    jobs += [("control", None, s) for s in ints(args.control_seeds)]
    jobs += [("fault", f, s) for f in args.faults.split(",") if f for s in ints(args.fault_seeds)]
    out = open(args.out, "a") if args.out else None
    for kind, fault, seed in jobs:
        if kind == "sound":
            r = sound(prep, seed, device)
        elif kind == "control":
            r = control(prep, seed, device)
        else:
            with faults.plant(fault):
                r = sound(prep, seed, device)
        r = {"workload": args.workload, "kind": kind, "fault": fault, "seed": seed,
             "card": torch.cuda.get_device_name(device), **r}
        line = json.dumps(r, default=str)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
