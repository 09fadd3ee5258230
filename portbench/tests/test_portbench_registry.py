"""Discovery by name, and BENCHMARK.json against the benchmark's rules."""

import json
import os
import re
import shutil

import pytest

from portbench import run as R

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = R.benchmark()


@pytest.mark.parametrize("entry", BENCH["workloads"],
                         ids=lambda w: w["name"])
def test_each_cell_is_found_by_name(entry):
    cell = R.Cell(entry["name"], 1, ["cpu"])
    assert cell.workload["config"] == entry["config"]
    for fn in ("setup", "window", "gather", "close"):
        assert callable(getattr(cell.driver, fn))
    assert set(cell.workload["limits"]) <= {
        "target_mel", "init_cp", "plan_loss", "plan_step", "plan_adam",
        "prod_metrics", "synthesis", "start_state", "train_loss",
        "train_grad", "train_change", "tube"}


@pytest.mark.parametrize("entry", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_each_per_layer_metric_has_a_reader(entry):
    assert callable(R.metric_reader(entry["name"]))


def test_each_configuration_file_states_its_models():
    for c in BENCH["configs"]:
        with open(os.path.join(R.ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert set(cfg["models"]) <= set(cfg["loaded"])


def test_a_new_cell_config_and_metric_are_files_only(tmp_path,
                                                      monkeypatch):
    bench = tmp_path / "portbench"
    for kind in ("workloads", "configs", "metrics"):
        shutil.copytree(os.path.join(R.BENCH, kind), bench / kind)
    w = R.load_json("workloads", "resynth-1s")
    w.update(cp_frames=100, config="paule-short")
    (bench / "workloads" / "resynth-0.25s.json").write_text(json.dumps(w))
    c = R.load_json("configs", "paule-acoustic_semvec")
    (bench / "configs" / "paule-short.json").write_text(
        json.dumps(dict(c, name="paule-short")))
    (bench / "metrics" / "new_metric.resynth.py").write_text(
        "def read(cell):\n    return 1.5\n")
    monkeypatch.setattr(R, "BENCH", str(bench))
    cell = R.Cell("resynth-0.25s", 1, ["cpu"])
    assert cell.workload["cp_frames"] == 100
    assert cell.config["name"] == "paule-short"
    assert cell.driver.__name__ == "portbench.drivers.resynth"
    assert R.metric_reader("new_metric.resynth")(cell) == 1.5


def test_benchmark_json_keeps_the_rules():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert b["command"] == ["python3", "-m", "portbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for cell in cells:
        reported = [m for m in b["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", [cell])
                   for m in b["per_layer"])
    for m in b["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(
        1, len(b["workloads"]) // 4)
