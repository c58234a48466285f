"""The benchmark's files against its contract, the traffic generator, the
trace reduction, and the run's refusals; one test drives a cell on the
card where there is one."""

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import BENCH, tiny, tiny_cell

ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def load(kind, name):
    with open(os.path.join(BENCH, kind, f"{name}.json")) as fh:
        return json.load(fh)


def test_benchmark_json_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert b["command"] == ["python3", "benchmark/run.py"]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    assert len(json.dumps(b).encode()) <= 64 * 1024


def test_cells_name_existing_configs_and_mixes():
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    for w in b["workloads"]:
        cell = load("workloads", w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]
                ) == (w["config"], w["traffic"], w["chips"], w["why"])
        assert w["config"] in configs
        cfg = load("configs", w["config"])
        assert cfg["name"] == w["config"]
        assert cfg["reduced"] == configs[w["config"]]["reduced"]
    used = {w["config"] for w in b["workloads"]}
    assert used == set(configs)


def test_loops_and_models_are_found_by_name():
    """Each cell's mix names a loop file and its configuration a model
    file, each with what the harness calls."""
    from harness.common import cell, model, plugin
    for w in bench()["workloads"]:
        c = cell(w["name"])
        loop = plugin("loops", c["traffic"]["loop"])
        assert callable(loop.drive) and callable(loop.control_readings)
        m = model(c["config"])
        for fn in ("reference", "forward_flops", "attention_sites", "port",
                   "transform"):
            assert callable(getattr(m, fn)), (c["config"]["model"], fn)
        built = ("build_trainer" if c["traffic"]["loop"] == "train"
                 else "build_predictor")
        assert callable(getattr(m, built))
    with pytest.raises(FileNotFoundError, match="no loops file"):
        plugin("loops", "no_such_loop")


def _reports(b, cell):
    return {m["name"] for m in b["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}


def test_every_metric_names_cells_that_report_what_it_moves():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        reported = _reports(b, cell)
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in b["per_layer"])
    for m in b["per_layer"]:
        for cell in m.get("workloads", cells):
            assert m["moves"] in _reports(b, cell), (m["name"], cell)


def test_every_per_layer_metric_has_its_reader():
    from harness.common import plugin
    for m in bench()["per_layer"]:
        mod = plugin("metrics", m["name"])
        assert mod.UNIT == m["unit"] and callable(mod.read)
        assert mod.read({"kind": "none"}) is None


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = bench()["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", ["tav.train.b8", "text_video.train.b8",
                                  "tav.serve.b32"])
def test_generator_is_deterministic_per_seed(cell):
    from harness import data
    c = tiny_cell(cell)
    a = data.make_pool(c["config"], c["traffic"], 2**31 + 5)
    b = data.make_pool(c["config"], c["traffic"], 2**31 + 5)
    d = data.make_pool(c["config"], c["traffic"], 11)
    for k in a[0]:
        np.testing.assert_array_equal(a[0][k], b[0][k])
        assert not np.array_equal(a[0][k], d[0][k]) or k.endswith("mask")
        if k.endswith("mask"):
            # the same lengths for every seed, in another order
            assert sorted(a[0][k].sum(1)) == sorted(d[0][k].sum(1))
    np.testing.assert_array_equal(a[1], b[1])


def test_trace_reduction_union_and_gap_names():
    from harness.trace import kernel_family, reduce
    dev = [(10, 20, "flash_fwd_tma"), (15, 30, "sm90_xmma_gemm"),
           (50, 60, "Memcpy HtoD (Pageable -> Device)")]
    host = [(0, 100, "bench.train_step"), (32, 48, "aten::copy_"),
            (35, 45, "cudaMemcpyAsync")]
    s = reduce(dev, host, 0, 100, 2)
    assert s.busy_s == pytest.approx(30e-9)
    assert s.window_s == pytest.approx(100e-9)
    assert s.gaps == pytest.approx({
        "bench.train_step / python": 50e-9,
        "bench.train_step / cudaMemcpyAsync": 20e-9})
    assert s.kernels_matching("flash_fwd") == (1, pytest.approx(10e-9))
    assert kernel_family("void at::native::convert_kernel") != "conv"
    assert kernel_family("cudnn::winograd_dgrad") == "conv backward"
    bd = s.breakdown()
    assert bd["device_ops"][0][0] == "sm90_xmma_gemm"


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "tav.train.b8", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    if p.returncode == 0:
        pytest.skip("a card is present")
    assert p.returncode == 2 and p.stdout.strip() == ""


def test_run_fails_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    gives no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import time\n"
            "from conftest import tiny_cell\n"
            "import run\n"
            "print(run.execute(tiny_cell('tav.train.b8'), 1, 0.1, False, "
            "'cpu', time.time(), run.declared()))\n")
    env = dict(os.environ, PYTHONPATH=str(tmp_path / "benchmark" / "tests"))
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "correct" not in p.stdout
    assert "mme_tpu_torch" in p.stderr


@pytest.mark.cuda
def test_cell_runs_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "tav.serve.b32", "--seed", "3", "--seconds", "2",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"


def test_tiny_configs_keep_the_published_keys():
    for name in ("tav", "text_video"):
        assert set(tiny(name)) == set(load("configs", name))
