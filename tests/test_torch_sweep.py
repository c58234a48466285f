"""The port's sweeps (``mme_tpu_torch/sweep.py``, ``cli/sweep.py``)
against ``mme_tpu/core/sweep.py`` and ``mme_tpu/cli/sweep.py``.

- The port's YAML reader equals ``yaml.safe_load`` on every
  ``configs/*.yaml``, on every YAML string of ``tests/test_sweep_*.py`` and
  on the scalar forms YAML 1.1 resolves (``.25``, ``1.0e-5`` against the
  string ``5e-6``, ``True``, ``no``, ``~``, octal, hex), and raises on what
  it does not read.
- Trial sequences (random and grid, seeds 0 and 7, offsets and strides)
  and TPE proposals (categorical, uniform, log-uniform, int-uniform,
  maximise) equal JAX's value for value; a bayes ``run_sweep`` on a
  quadratic gives JAX's sequence and best.
- The CLI: program names, one in-process ``tav_nn`` trial on the CPU from
  ``configs/tav.yaml`` cut to one epoch of batch 8 (JAX's first trial's
  parameters), ``--workers 2`` (the merge, ``--pin_env``, each worker's own
  checkpoint directory, the worker command), a bayes worker's sibling
  refresh, and a metric the summary lacks, each beside JAX's CLI with the
  same stand-in entry.
"""

import ast
import glob
import importlib
import json
import os
import types

import numpy as np
import pytest
import torch
import yaml

from mme_tpu.cli import sweep as j_sweep_cli
from mme_tpu.core import sweep as j_sweep

from mme_tpu_torch import sweep
from mme_tpu_torch.cli import sweep as sweep_cli

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def _test_yamls():
    """The YAML strings of the JAX package's sweep tests."""
    out = []
    for path in sorted(glob.glob(os.path.join(REPO, "tests",
                                              "test_sweep_*.py"))):
        with open(path) as f:
            tree = ast.parse(f.read())
        out += [n.value for n in ast.walk(tree)
                if isinstance(n, ast.Constant) and isinstance(n.value, str)
                and "parameters:" in n.value]
    return out


SCALARS = """
a: .25
b: 1.0e-5
c: 5e-6
d: True
e: no
f: ~
g: 0x1F
h: 017
i: 1_000
j: -.inf
k: 1:30
l: 'it''s # not a comment'
m: "tab\\there"
n: [1, 'x', {p: q, r: [s, 2.5]}]
o: {}
p: []
q:
r: -1.5e+3
s: +7
t: 1.
u: off
v: ../tav_nn.py   # a comment
w: {name: "val/loss", goal: minimize}
"""


YAMLS = {**{os.path.basename(p): open(p).read() for p in CONFIGS},
         **{f"test_sweep_{i}": t for i, t in enumerate(_test_yamls())},
         "scalars": SCALARS, "plain": "plain", "empty": "",
         "comment": "# x\n"}


@pytest.mark.parametrize("text", list(YAMLS.values()), ids=list(YAMLS))
def test_yaml_reader_equals_safe_load(text):
    assert repr(sweep.load_yaml(text)) == repr(yaml.safe_load(text))


@pytest.mark.parametrize("text", ["- a\n- b", "a: &x 1", "a: *x",
                                  "a: !!str 1", "a: |\n  x", "---\na: 1",
                                  "a: 2001-12-14", "a: [1, 2"])
def test_yaml_reader_refuses_outside_its_subset(text):
    with pytest.raises(sweep.YamlError):
        sweep.load_yaml(text)


def _both(text):
    return sweep.SweepConfig.from_yaml(text), \
        j_sweep.SweepConfig.from_yaml(text)


def _grid_only(cfg):
    return {k: v for k, v in cfg.parameters.items() if "values" in v}


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_trials_equal_jax_for_every_config(path):
    ours, theirs = _both(path)
    assert ours == sweep.SweepConfig(**vars(theirs))
    for method in ("bayes", "random", "grid"):
        o = sweep.SweepConfig(**{**vars(ours), "method": method})
        t = j_sweep.SweepConfig(**{**vars(theirs), "method": method})
        if method == "grid":
            o.parameters, t.parameters = _grid_only(o), _grid_only(t)
        for seed, offset, stride in ((0, 0, 1), (7, 0, 1), (7, 1, 3),
                                     (0, 2, 4)):
            got = list(sweep.iter_trials(o, 12, seed, offset, stride))
            want = list(j_sweep.iter_trials(t, 12, seed, offset, stride))
            assert repr(got) == repr(want), (method, seed, offset, stride)


TPE_YAML = """
method: bayes
metric: {name: val/loss, goal: %s}
parameters:
  c: {values: [0, 1, 2, 3]}
  x: {distribution: uniform, min: -5.0, max: 5.0}
  lr: {distribution: log_uniform, min: 1.0e-6, max: 1.0e-2}
  layers: {distribution: int_uniform, min: 2, max: 9}
  fixed: {value: 3}
"""


@pytest.mark.parametrize("goal", ["minimize", "maximize"])
@pytest.mark.parametrize("n_hist", [0, 3, 12])
def test_tpe_propose_equals_jax(goal, n_hist):
    ours, theirs = _both(TPE_YAML % goal)
    rng = np.random.RandomState(100 + n_hist)
    hist = []
    for _ in range(n_hist):
        p = {"c": int(rng.randint(4)), "x": float(rng.uniform(-5, 5)),
             "lr": float(np.exp(rng.uniform(np.log(1e-6), np.log(1e-2)))),
             "layers": int(rng.randint(2, 10)), "fixed": 3}
        hist.append((p, {"val/loss": (p["x"] - 2) ** 2 + p["c"]
                         + abs(p["layers"] - 6)}))
    if n_hist:
        hist.append(({"c": 1, "x": 0.0, "lr": 1e-4, "layers": 3},
                     {"val/loss": float("nan")}))     # not scored
    o_hist = [sweep.TrialResult(p, m) for p, m in hist]
    t_hist = [j_sweep.TrialResult(p, m) for p, m in hist]
    ro, rt = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(6):
        got = sweep.tpe_propose(ours, o_hist, ro)
        want = j_sweep.tpe_propose(theirs, t_hist, rt)
        assert repr(got) == repr(want)
    assert repr(ro.get_state()) == repr(rt.get_state())


def _quad(params):
    return {"val/loss": float((params["x"] - 2.0) ** 2)}


@pytest.mark.parametrize("seed", [3, 7])
def test_bayes_run_sweep_equals_jax(seed):
    text = TPE_YAML % "minimize"
    ours, theirs = _both(text)
    seen = {"o": [], "t": []}

    def trial(key):
        def fn(params):
            seen[key].append(params)
            return {"val/loss": _quad(params)["val/loss"]
                    + 0.1 * params["c"]}
        return fn

    best_o = sweep.run_sweep(ours, trial("o"), 14, seed=seed,
                             log=lambda s: None)
    best_t = j_sweep.run_sweep(theirs, trial("t"), 14, seed=seed,
                               log=lambda s: None)
    assert repr(seen["o"]) == repr(seen["t"])
    assert repr(best_o.params) == repr(best_t.params)
    assert best_o.metrics == best_t.metrics
    obs = [sweep.TrialResult({"x": v, "c": 0, "lr": 1e-4, "layers": 5,
                              "fixed": 3}, {"val/loss": (v - 2) ** 2})
           for v in np.linspace(-5, 5, 8)]
    b_o = sweep.run_sweep(ours, _quad, 4, seed=seed, log=lambda s: None,
                          observations=obs)
    b_t = j_sweep.run_sweep(theirs, _quad, 4, seed=seed, log=lambda s: None,
                            observations=[j_sweep.TrialResult(
                                r.params, r.metrics) for r in obs])
    assert repr(b_o.params) == repr(b_t.params)


@pytest.mark.parametrize("program", [
    *[sweep.SweepConfig.from_yaml(p).program for p in CONFIGS],
    "../tav_nn.py", "../audio_nn.py", "../text_nn.py", None])
def test_entry_from_program(program):
    name = sweep_cli._entry_from_program(program)
    assert name == j_sweep_cli._entry_from_program(program)
    importlib.import_module(f"mme_tpu_torch.cli.{name}")


def test_one_tav_trial_in_process(tmp_path, monkeypatch):
    """``configs/tav.yaml`` cut to one epoch of batch 8 runs one tiny
    ``tav_nn`` trial on the CPU, with JAX's first trial's parameters."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MME_WANDB_NAME", "caller")
    with open(os.path.join(REPO, "configs", "tav.yaml")) as f:
        text = f.read().replace("epoch:\n    values: [6]",
                                "epoch:\n    values: [1]").replace(
            "batch_size:\n    values: [1]", "batch_size:\n    values: [8]")
    (tmp_path / "tav.yaml").write_text(text)
    best = sweep_cli.main(["tav.yaml", "--trials", "1",
                           "--dataset", "synthetic"], device="cpu")
    want = next(j_sweep.iter_trials(j_sweep.SweepConfig.from_yaml(text), 1))
    assert repr(best.params) == repr(want)
    assert best.params["epoch"] == 1 and best.params["batch_size"] == 8
    assert best.metrics["val/loss"] == best.metrics["test/loss"]
    assert np.isfinite(best.metrics["val/loss"])
    assert os.path.isfile(tmp_path / "checkpoints" / "best_meta.json")
    assert os.environ["MME_WANDB_NAME"] == "caller"


GRID_YAML = """
method: grid
metric: {name: "val/loss", goal: minimize}
parameters:
  epoch: {values: [1]}
  batch_size: {values: [32]}
  learning_rate: {values: [1.0e-4, 5.0e-5]}
"""


class _Popen:
    """Records a worker's command and environment and writes its results
    file, in place of a subprocess."""
    calls = []

    def __init__(self, cmd, env):
        _Popen.calls.append((cmd, env))
        args = dict(zip(cmd[4::2], cmd[5::2]))
        trial = next(sweep.iter_trials(
            sweep.SweepConfig.from_yaml(cmd[3]), 1, int(args["--seed"]),
            int(args["--trial_offset"]), int(args["--stride"])))
        with open(args["--results"], "w") as f:
            f.write(json.dumps({"params": trial, "metrics": {
                "val/loss": trial["learning_rate"] * 1e4}}) + "\n")

    def wait(self):
        return 0


def test_workers_command_pin_and_checkpoint_dirs(tmp_path, monkeypatch):
    (tmp_path / "grid.yaml").write_text(GRID_YAML)
    _Popen.calls = []
    monkeypatch.setattr(sweep_cli.subprocess, "Popen", _Popen)
    best = sweep_cli.main([str(tmp_path / "grid.yaml"), "--entry", "text_nn",
                           "--trials", "2", "--workers", "2", "--pin_env",
                           "MME_TEST_PIN", "--dataset", "synthetic"],
                          device="cpu")
    assert best.params["learning_rate"] == 5e-5
    (c0, e0), (c1, e1) = _Popen.calls
    for w, (cmd, env) in enumerate(_Popen.calls):
        assert cmd[1:3] == ["-m", "mme_tpu_torch.cli.sweep"]
        args = dict(zip(cmd[4::2], cmd[5::2]))
        assert args["--trial_offset"] == str(w) and args["--stride"] == "2"
        assert args["--device"] == "cpu" and args["--entry"] == "text_nn"
        assert env["MME_TEST_PIN"] == str(w)
        assert env["MME_SWEEP_WORKER"] == str(w)
    assert e0["MME_CHECKPOINT_DIR"] != e1["MME_CHECKPOINT_DIR"]


def test_two_worker_processes(tmp_path, monkeypatch):
    """Two real agent processes, one trial each: merged results and each
    worker's own checkpoint directory under ``./checkpoints``."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MME_TINY", "1")
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.delenv("MME_CHECKPOINT_DIR", raising=False)
    (tmp_path / "grid.yaml").write_text(GRID_YAML)
    best = sweep_cli.main(["grid.yaml", "--entry", "text_nn", "--trials",
                           "2", "--workers", "2", "--dataset", "synthetic"],
                          device="cpu")
    assert best.params["learning_rate"] in (1e-4, 5e-5)
    assert np.isfinite(best.metrics["val/loss"])
    for w in range(2):
        d = tmp_path / "checkpoints" / f"sweep_worker_{w}"
        assert (d / "best_meta.json").is_file(), w
    assert not (tmp_path / "checkpoints" / "best_meta.json").exists()


BAYES_YAML = """
method: bayes
metric: {name: "val/loss", goal: minimize}
parameters:
  x: {distribution: uniform, min: -5.0, max: 5.0}
"""


def _fake_entry(seen, summary=None):
    def main(argv, device=None):
        args = dict(zip(argv[::2], argv[1::2]))
        x = float(args["--x"]) if "--x" in args else 0.0
        seen.append((x, device))
        return summary if summary is not None else {"test/loss":
                                                    (x - 2.0) ** 2}
    return types.SimpleNamespace(main=main)


def _run_both(monkeypatch, argv, summary=None):
    """The port's CLI and JAX's on the same stand-in entry."""
    seen_o, seen_t = [], []
    monkeypatch.setattr(sweep_cli.importlib, "import_module",
                        lambda name: _fake_entry(seen_o, summary))
    best_o = sweep_cli.main(argv[0], device="cpu")
    jax_entry = _fake_entry(seen_t, summary)
    monkeypatch.setattr(j_sweep_cli.importlib, "import_module",
                        lambda name: types.SimpleNamespace(
                            main=lambda a: jax_entry.main(a)))
    best_t = j_sweep_cli.main(argv[1])
    return best_o, best_t, seen_o, seen_t


def test_bayes_worker_reads_its_siblings(tmp_path, monkeypatch):
    (tmp_path / "sweep.yaml").write_text(BAYES_YAML)
    for d in ("o", "t"):
        (tmp_path / d).mkdir()
        with open(tmp_path / d / "worker_0.jsonl", "w") as f:
            for v in np.linspace(-5, 5, 12):
                f.write(json.dumps({"params": {"x": float(v)}, "metrics": {
                    "val/loss": float((v - 2) ** 2)}}) + "\n")
    argv = lambda d: [str(tmp_path / "sweep.yaml"), "--entry", "fake",
                      "--trials", "6", "--seed", "11", "--trial_offset", "1",
                      "--stride", "2", "--results",
                      str(tmp_path / d / "worker_1.jsonl")]
    best_o, best_t, seen_o, seen_t = _run_both(monkeypatch,
                                               (argv("o"), argv("t")))
    assert [x for x, _ in seen_o] == [x for x, _ in seen_t]
    assert {dev for _, dev in seen_o} == {"cpu"}
    assert best_o.params == best_t.params
    assert abs(best_o.params["x"] - 2.0) < 1.0
    with open(tmp_path / "o" / "worker_1.jsonl") as f:
        assert [json.loads(line)["params"]["x"] for line in f] == \
            [x for x, _ in seen_o]


def test_missing_metric_scores_zero_as_jax(tmp_path, monkeypatch, capsys):
    """``train/train_loss`` (10 of the 12 configs) is in no summary: JAX
    scores it 0.0; the port does too and says so."""
    (tmp_path / "bert.yaml").write_text(
        open(os.path.join(REPO, "configs", "bert.yaml")).read())
    argv = [str(tmp_path / "bert.yaml"), "--trials", "2"]
    best_o, best_t, _, _ = _run_both(monkeypatch, (argv, argv),
                                     summary={"test/loss": 1.5})
    assert best_o.metrics["train/train_loss"] == 0.0
    assert best_t.metrics["train/train_loss"] == 0.0
    assert repr(best_o.params) == repr(best_t.params)
    out = capsys.readouterr().out
    assert out.count("sweep metric 'train/train_loss' is not in the text_nn "
                     "summary: scored 0.0") == 2
