"""One cell's step timeline by the program's own spans, on the card.

    python3 benchmark/spans_pass.py --workload <cell> --seed <n> --seconds <s> [--out DIR]

Set-up as ``drivers/pretrain.run`` does it (the seeded shards and weights, the
trainer, the checked warm-up steps), then an unprofiled window of whole steps
with the program's spans off for ``seconds``, the program's
``HostPrefetcher.wait_s`` read before and after it, then the traffic's
``trace_steps`` more steps through ``harness/spans.profile_spans``: the device
alone with the spans on. Prints the ten spans that hold the most device time
and the coverage to standard error, and one JSON object last on standard
output: the window's seconds a step, the program's and the benchmark's own
mean wait for the prefetcher in it, the spans pass's seconds a step, the reduction
(``harness/spans.reduce_spans``) and the five span metrics
(``harness/spans.METRICS``); with ``--out`` the object is also written to
``DIR/<cell>.json``. No reference runs: nothing here decides ``correct``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
for _p in (str(BENCH.parent), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import manifest, peaks  # noqa: E402
from harness import spans as sp  # noqa: E402
from harness import traffic as gen  # noqa: E402
from harness import weights as seeded  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None, help="a directory for <cell>.json")
    return p.parse_args(argv)


def run(workload: str, seed: int, seconds: float, device: str = "cuda:0") -> dict:
    import torch

    man = manifest.load_manifest()
    cell = manifest.cell(man, workload)
    traffic = manifest.traffic(cell["traffic"])
    config = manifest.config(man, cell["config"])
    drv = manifest.load_module("drivers", traffic["kind"])
    dev = torch.device(device)
    t = traffic["seq_len"]
    with tempfile.TemporaryDirectory(prefix="gpt2-spans-") as tmp:
        paths = gen.write_shards(os.path.join(tmp, "shards"), traffic["tokens"], seed)
        flat, init = seeded.make(config, t, seed, dev)
        trainer = drv.Trainer(config, traffic, seed, dev, os.path.dirname(paths[0]), init)
        del flat, init
        try:
            idx = int(traffic["checked_steps"])
            for s in range(idx):
                trainer.step(s)
            drv.sync(dev)
            setup_s = time.perf_counter() - T_START

            pf = trainer.prefetch
            wait0 = getattr(pf, "wait_s", None)
            steps, waited = 0, 0.0
            t0 = time.perf_counter()
            while True:
                waited += trainer.step(idx)[1]
                idx += 1
                steps += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            drv.sync(dev)
            window_s = time.perf_counter() - t0
            window = {"steps": steps, "seconds": window_s, "prefetch_wait_s": waited}
            if wait0 is not None:
                window["data_wait_s"] = pf.wait_s - wait0

            n = int(traffic["trace_steps"])
            t1 = time.perf_counter()
            red = sp.profile_spans(lambda: [trainer.step(idx + i) for i in range(n)], n,
                                   os.path.join(tmp, "spans.json"))
            pass_s = time.perf_counter() - t1
        finally:
            trainer.close()
    if red is None:
        raise SystemExit("the program has no spans (obs/spans.py)")
    rec = SimpleNamespace(dims=seeded.dims(config, t), traffic=traffic, compute=traffic["policy"],
                          peaks=peaks.for_device(torch.cuda.get_device_name(dev)), trace=red,
                          window=window)
    sp.report(red)
    return {"workload": workload, "seed": seed, "card": drv.card(dev), "setup_s": setup_s,
            "window_step_s": window_s / steps, "window_steps": steps,
            "spans_pass_step_s": red["window_us"] * 1e-6 / n, "spans_pass_wall_s": pass_s,
            "closure": sp.closure(red), "prefetch_wait_ms": 1e3 * waited / steps,
            "metrics": {k: f(rec) for k, f in sp.METRICS.items()}, "reduction": red}


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    torch.set_num_threads(1)  # as run.py
    out = run(args.workload, args.seed, args.seconds)
    print(f"[spans] window {out['window_step_s']:.4f} s a step, spans pass "
          f"{out['spans_pass_step_s']:.4f} s a step; metrics {out['metrics']}", file=sys.stderr)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"{args.workload}.json"), "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
