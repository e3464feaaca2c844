"""The harness finds every cell's configuration, traffic mix, limits,
judge and metric readers by the names in BENCHMARK.json, and the file
keeps the benchmark's contract."""
import json
import re
import types

import pytest

from portbench.core import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_found_by_name(workload):
    cell = spec.load_cell(workload)
    assert cell.config["preset"]
    assert cell.traffic["kind"] in ("epoch", "prefilter")
    assert cell.limits, "every cell has limits"
    judge = spec.judge_module(cell.traffic["judge"])
    for part in ("outputs", "reference", "judge", "control", "fault"):
        assert callable(getattr(judge, part))
    assert judge.FAULTS
    names = {m.name for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.metric_reader(m.name))


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_exists(metric):
    assert callable(spec.metric_reader(metric))


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no.such_cell")
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_metric")
    with pytest.raises(FileNotFoundError):
        spec.judge_module("no_such_judge")


@pytest.mark.parametrize("method", ["loss_gmm", "zscore_dbscan", "autoencoder"])
def test_unknown_strain_method_raises(method):
    """A strain method the judge does not know is refused, not read as no
    strain, which would leave its strain event unjudged."""
    judge = spec.judge_module("dcgan_epoch")
    run = types.SimpleNamespace(config={"strain": {"method": method}})
    with pytest.raises(ValueError, match=method):
        judge.settings(run, 3)


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        for w in m["workloads"]:
            assert w in moved.get("workloads", WORKLOADS)
    texts = [c[k] for c in BENCH["configs"] for k in ("source", "why")]
    texts += [w["why"] for w in BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]
    for text in texts:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for entry in BENCH["configs"] + BENCH["workloads"] + METRICS:
        assert NAME.match(entry["name"])
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
