"""The benchmark's manifest (``BENCHMARK.json``) and the files it names.

Everything that belongs to one configuration, one traffic mix, one cell or one
metric is a file of its own, found by the name the manifest gives it:

  * ``benchmark/configs/<config>.json``  the model as it is run (the path is
    also the config's ``file`` in the manifest);
  * ``benchmark/traffic/<traffic>.json`` the job's parameters, read by the
    driver that its ``kind`` names (``benchmark/drivers/<kind>.py``);
  * ``benchmark/limits/<cell>.json``     the limits of the numbers that decide
    ``correct``, with the readings they were set from;
  * ``benchmark/metrics/<metric>.py``    a reader, ``read(run) -> float | None``.

A later cell, configuration or metric is added by adding such files and an
entry in the manifest; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def check_name(name: str, what: str = "name") -> str:
    """Raise unless ``name`` is a valid manifest name: a letter, digit or _
    first, then at most 63 more of letters, digits, _, . and -."""
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise ValueError(f"{what} {name!r}: names are 1-64 of [A-Za-z0-9_.-], "
                         "starting with a letter, a digit or _")
    return name


def check_unit(unit: str) -> str:
    """Raise unless ``unit`` is 1-16 of letters, digits, _, /, %, . and -."""
    if not isinstance(unit, str) or not UNIT_RE.match(unit):
        raise ValueError(f"unit {unit!r}: units are 1-16 of [A-Za-z0-9_/%.-]")
    return unit


def load_manifest(path: Path = MANIFEST) -> dict:
    """The manifest, with every name and unit checked."""
    man = json.loads(Path(path).read_text())
    for c in man["configs"]:
        check_name(c["name"], "config")
        for key in c["reduced"]:
            check_name(key, "reduced key")
    for w in man["workloads"]:
        check_name(w["name"], "workload")
        check_name(w["config"], "config")
        check_name(w["traffic"], "traffic")
    for m in man["end_to_end"] + man["per_layer"]:
        check_name(m["name"], "metric")
        check_unit(m["unit"])
        if m["source"] not in SOURCES:
            raise ValueError(f"metric {m['name']}: source {m['source']!r}")
        if m["better"] not in ("lower", "higher"):
            raise ValueError(f"metric {m['name']}: better {m['better']!r}")
    return man


def _json(kind: str, name: str) -> dict:
    path = BENCH_DIR / kind / f"{check_name(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def cell(man: dict, name: str) -> dict:
    """The workload entry of the manifest named ``name``."""
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in {MANIFEST.name}")


def config(man: dict, name: str) -> dict:
    """The configuration file of the config named ``name``."""
    for c in man["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in {MANIFEST.name}")


def traffic(name: str) -> dict:
    return _json("traffic", name)


def limits(cell_name: str) -> dict:
    return _json("limits", cell_name)


def metrics_for(man: dict, cell_name: str, trace: bool) -> list:
    """The metrics a run of the cell reports: the end-to-end ones with
    ``trace`` off, the per-layer ones with it on; a metric with a
    ``workloads`` list only in the cells it names."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (a metric's reader, a
    traffic kind's driver)."""
    path = BENCH_DIR / kind / f"{check_name(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
