"""The manifest and every file it names load by name and keep to the rules."""

import json

import pytest

from harness import manifest


@pytest.fixture(scope="module")
def man():
    return manifest.load_manifest()


def test_manifest_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert man["command"][:2] == ["python3", "benchmark/run.py"]
    assert man["paths"] == ["benchmark"]
    assert 1 <= man["run_seconds"] <= 51
    names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e


def test_every_cell_loads(man):
    for w in man["workloads"]:
        prep_traffic = manifest.traffic(w["traffic"])
        assert manifest.config(man, w["config"])["n_layer"] > 0
        assert manifest.load_module("drivers", prep_traffic["kind"]).run
        lim = manifest.limits(w["name"])
        assert set(lim["limits"]) == {"loss_gap", "grad_norm_gap", "update_norm_gap"}
        assert w["chips"] == 1
        assert manifest.metrics_for(man, w["name"], False)
        assert manifest.metrics_for(man, w["name"], True)


def test_every_metric_loads(man):
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(manifest.load_module("metrics", m["name"]).read)


def test_every_config_file(man):
    for c in man["configs"]:
        cfg = manifest.config(man, c["name"])
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


@pytest.mark.parametrize("name", ["gpt2-124m", "a.b_c-1", "_x", "9lives", "x" * 64])
def test_good_names(name):
    assert manifest.check_name(name) == name


@pytest.mark.parametrize("name", ["", "a b", "a,b", "a/b", "-a", ".a", "x" * 65, "μs", "a\tb"])
def test_bad_names(name):
    with pytest.raises(ValueError):
        manifest.check_name(name)


@pytest.mark.parametrize("unit", ["tokens/s", "%", "GiB", "ms", "s", "us", "x" * 16])
def test_good_units(unit):
    assert manifest.check_unit(unit) == unit


@pytest.mark.parametrize("unit", ["", "tokens per second", "μs", "x" * 17, "a,b", "a\nb"])
def test_bad_units(unit):
    with pytest.raises(ValueError):
        manifest.check_unit(unit)


def test_bad_manifest_refused(tmp_path):
    man = json.loads(manifest.MANIFEST.read_text())
    man["end_to_end"][0]["unit"] = "tokens per s"
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(man))
    with pytest.raises(ValueError):
        manifest.load_manifest(path)


def test_missing_files_refused(man):
    with pytest.raises(FileNotFoundError):
        manifest.traffic("no-such-traffic")
    with pytest.raises(FileNotFoundError):
        manifest.load_module("metrics", "no_such_metric")
    with pytest.raises(KeyError):
        manifest.cell(man, "no-such-cell")
