"""What a run loads: never JAX, its libraries or the JAX package; the
reference and the harness nothing of the program. Without a card a run goes
as far as it can, exits non-zero and prints nothing on standard output."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from harness import jaxcheck, manifest

ROOT = Path(manifest.ROOT)
PROBE = r"""
import contextlib, io, json, runpy, sys
sys.argv = ["benchmark/run.py", "--workload", sys.argv[1], "--seed", "2147483999",
            "--seconds", "1", "--trace", sys.argv[2]]
out, code = io.StringIO(), None
with contextlib.redirect_stdout(out):
    try:
        runpy.run_path("benchmark/run.py", run_name="__main__")
    except SystemExit as e:
        code = e.code
print(json.dumps({"code": code, "stdout": out.getvalue(),
                  "modules": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def _probe(code, *args, env=None):
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _cells():
    return [w["name"] for w in manifest.load_manifest()["workloads"]]


@pytest.mark.parametrize("workload", _cells())
def test_run_without_a_card(workload):
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    got = _probe(PROBE, workload, "1", env=env)
    assert got["code"] == 3
    assert got["stdout"] == ""
    assert "gpt2_vision_language_tpu_torch" in got["modules"]  # it went as far as the program
    assert jaxcheck.loaded(got["modules"]) == []


@pytest.mark.parametrize("module", ["reference.gpt2", "harness.compare", "harness.trace",
                                    "harness.traffic", "harness.weights", "harness.manifest"])
def test_yardstick_imports_nothing_of_the_program(module):
    code = (f"import sys; sys.path[:0] = [{str(ROOT / 'benchmark')!r}]; import {module}, json; "
            "print(json.dumps({'modules': sorted({m.split('.')[0] for m in sys.modules})}))")
    got = _probe(code)
    assert "gpt2_vision_language_tpu_torch" not in got["modules"]
    assert jaxcheck.loaded(got["modules"]) == []


def test_jaxcheck_compares_whole_names():
    assert jaxcheck.loaded(["gpt2_vision_language_tpu_torch.models", "jaxtyping", "flaxen",
                            "numpy"]) == []
    assert jaxcheck.loaded(["jax.numpy", "gpt2_vision_language_tpu.core", "flax"]) == [
        "flax", "gpt2_vision_language_tpu", "jax"]
