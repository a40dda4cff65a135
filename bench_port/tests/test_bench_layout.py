"""The benchmark finds every cell, configuration, driver and per-layer
metric by its name, and a cell added as new files only is picked up."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_port import harness


def test_every_entry_loads_by_name():
    bench = harness.benchmark()
    for c in bench["configs"]:
        assert harness.config(c["name"])["name"] == c["name"]
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
    for w in bench["workloads"]:
        wl = harness.workload(w["name"])
        harness.load_module("drivers", wl["driver"]).run
        assert set(wl["limits"]) and wl["config"] == w["config"]
        for m in harness.metric_entries(w["name"], True):
            harness.load_module("metrics", m["name"]).read
        assert {m["name"] for m in harness.metric_entries(
            w["name"], False)} >= {"setup_s"}


def test_a_cell_added_as_files_is_picked_up(tmp_path):
    for name in ("BENCHMARK.json",):
        shutil.copy(os.path.join(harness.ROOT, name), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    new = dict(bench["workloads"][0], name="smpl_eval_added",
               traffic="added")
    bench["workloads"].append(new)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if bench["workloads"][0]["name"] in m.get("workloads", []):
            m["workloads"].append("smpl_eval_added")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    src = tmp_path / "bench_port" / "workloads"
    spec = json.loads((src / (bench["workloads"][0]["name"] + ".json"))
                      .read_text())
    spec["traffic_params"]["clips"] = 4
    (src / "smpl_eval_added.json").write_text(json.dumps(spec))
    code = ("import sys; sys.path.insert(0, '.');"
            "from bench_port import harness as h;"
            "w = h.workload('smpl_eval_added');"
            "print(w['traffic_params']['clips'], w['driver'],"
            " sorted(m['name'] for m in h.metric_entries("
            "'smpl_eval_added', True)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, check=True)
    clips, driver, names = out.stdout.split(" ", 2)
    assert clips == "4" and driver == "smpl_eval"
    assert "kernels.roofline.eval" in names


def test_run_refuses_without_a_chip_or_the_program(tmp_path):
    """Without CUDA, or in a directory holding only the benchmark, no
    result and a nonzero exit."""
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload",
         "smpl_eval_ddpm1000", "--seed", "5", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("name", ["workloads", "configs"])
def test_names_and_units_keep_to_the_contract(name):
    import re

    bench = harness.benchmark()
    ok = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for e in bench[name]:
        assert ok.match(e["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert ok.match(m["name"]) and unit.match(m["unit"])
