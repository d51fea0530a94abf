"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is the manifest's (``BENCHMARK.json``) workload of that name. Its
configuration, traffic, limits and metric readers are files found by name
under ``benchmark/`` (``harness/manifest.py``); the traffic's ``kind`` names
the driver that runs it (``benchmark/drivers/<kind>.py``). With ``--trace 0``
the last line of standard output is one JSON object with the cell's
end-to-end metrics, with ``--trace 1`` with its per-layer metrics and the
trace's breakdown. Every number that decides ``correct`` is printed beside
its limit, as the last lines of standard error and as the last key of that
object.

The run needs a CUDA device: without one, or with fewer than the cell asks
for, it exits with code 3 and prints no result. It exits with code 4, and
prints no result, if JAX, its libraries or the JAX package are loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
for _p in (str(BENCH.parent), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import compare, jaxcheck, manifest, peaks  # noqa: E402

EXIT_NO_DEVICE = 3
EXIT_JAX = 4
NAME_CHARS = 160  # of a kernel's name in the breakdown


def err(*a):
    print(*a, file=sys.stderr, flush=True)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def prepare(workload: str, trace: bool) -> SimpleNamespace:
    """Everything a run of the cell needs from the files: the manifest entry,
    its configuration, traffic and limits, its driver and metric readers."""
    man = manifest.load_manifest()
    cell = manifest.cell(man, workload)
    traffic = manifest.traffic(cell["traffic"])
    metrics = manifest.metrics_for(man, workload, trace)
    return SimpleNamespace(
        cell=cell, config=manifest.config(man, cell["config"]), traffic=traffic,
        limits=manifest.limits(workload), metrics=metrics,
        driver=manifest.load_module("drivers", traffic["kind"]),
        readers={m["name"]: manifest.load_module("metrics", m["name"]) for m in metrics})


def breakdown(trace: dict) -> dict:
    ops = {}
    for name, us in trace["by_name"].items():
        key = name[:NAME_CHARS]
        ops[key] = ops.get(key, 0.0) + us * 1e-6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[label, us * 1e-6] for label, us in trace["gaps"][:10]]}


def execute(prep: SimpleNamespace, seed: int, seconds: float, trace: bool, device: str,
            t_start: float = T_START) -> dict:
    """Run the cell once on ``device`` and return its result object."""
    import torch

    dev = torch.device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    ctx = SimpleNamespace(config=prep.config, traffic=prep.traffic, seed=seed,
                          seconds=seconds, trace=trace, device=dev, t_start=t_start)
    rec = prep.driver.run(ctx)
    rec.peaks = peaks.for_device(kind)
    metrics = {}
    for m in prep.metrics:
        value = prep.readers[m["name"]].read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct, checks = compare.judge(prep.driver.compare(rec), prep.limits)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": kind,
                   "count": 1, "memory_peak_bytes": int(rec.memory_peak_bytes)}
    line = {"correct": bool(correct and rec.failed == 0), "attempted": int(rec.attempted),
            "failed": int(rec.failed), "metrics": metrics, "device": device_info}
    if rec.trace is not None:
        device_info["busy_s"] = rec.trace["busy_us"] * 1e-6
        device_info["window_s"] = rec.trace["window_us"] * 1e-6
        line["breakdown"] = breakdown(rec.trace)
    line["checks"] = {n: {k: _finite(v) for k, v in c.items()} for n, c in checks.items()}
    return line


def _finite(x):
    """A number as JSON can hold it: a value that is not finite becomes null."""
    return x if math.isfinite(x) else None


def main(argv=None) -> int:
    args = parse(argv)
    prep = prepare(args.workload, bool(args.trace))
    found = jaxcheck.loaded()
    if found:
        err(f"JAX loaded before the run: {found}")
        return EXIT_JAX
    import torch

    if not torch.cuda.is_available():
        err("no CUDA device: the benchmark measures the card and prints nothing without it")
        return EXIT_NO_DEVICE
    if torch.cuda.device_count() < prep.cell["chips"]:
        err(f"{torch.cuda.device_count()} CUDA devices; the cell asks for {prep.cell['chips']}")
        return EXIT_NO_DEVICE
    # load from one process with few threads: the host's work is launches and
    # small copies, and an idle intra-op pool only spins beside them
    torch.set_num_threads(1)
    line = execute(prep, args.seed, args.seconds, bool(args.trace), "cuda:0")
    found = jaxcheck.loaded()
    if found:
        err(f"JAX loaded by the run: {found}")
        return EXIT_JAX
    err(f"correct {line['correct']}")
    for name, c in line["checks"].items():
        err(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
