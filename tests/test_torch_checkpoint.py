"""The port's checkpoints (mme_tpu_torch/train/checkpoint.py) and the loop's
preemption path, on the CPU.

Round trips are bit-equal, sync and async, for fp32, bf16 and factored
AdamW state. The directory layout and meta files follow
mme_tpu/train/checkpoint.py through the same sequence of calls. A crash or
a failed write mid-save keeps the previous best, dead-pid orphans are
collected, and a save is not changed by a step taken while it is in flight
(the state is updated in place). SIGTERM mid-epoch saves ``latest`` and
stops; a resume prefers ``latest`` and ends on the parameters of a run that
was never interrupted, bit for bit.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mme_tpu.train import checkpoint as j_checkpoint

from mme_tpu_torch.train import checkpoint
from mme_tpu_torch.train.checkpoint import CheckpointManager
from mme_tpu_torch.train.steps import TrainState, make_optimizer

from tests.test_torch_loop import mlp_params, port_mlp_run

torch.set_num_threads(2)

SHAPES = [(300, 64), (64,), (7, 5), (3,)]   # the last leaf frozen


def make_state(state_dtype="fp32", seed=0, updates=2):
    """A state of four leaves after ``updates`` AdamW steps with random
    gradients; the factored state factors the first leaf."""
    g = torch.Generator().manual_seed(seed)
    params = [torch.nn.Parameter(torch.randn(s, generator=g))
              for s in SHAPES]
    tx = make_optimizer(lambda step: 1e-2, 1e-4, 1.0,
                        trainable_mask=[True, True, True, False],
                        state_dtype=state_dtype)
    state = TrainState.create(params, tx, use_accum=False, generator=g,
                              names=[f"leaf{i}" for i in range(4)])
    for _ in range(updates):
        tx.update(params, [torch.randn(s, generator=g) for s in SHAPES],
                  state.opt_state, g)
        state.step += 1
    return state, tx


def tensors(state):
    """Every tensor and counter of a state, in a fixed order."""
    o = state.opt_state
    out = [state.step, state.accum_count, o.count, o.seed]
    for group in (state.params, o.mu, o.nu, o.nu_row or [], o.nu_col or []):
        out.extend(group)
    return out


def assert_same(a, b):
    ta, tb = tensors(a), tensors(b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def fresh_like(state_dtype):
    """A state of the same structure with other values."""
    return make_state(state_dtype, seed=99, updates=0)[0]


@pytest.mark.parametrize("use_async", [False, True])
@pytest.mark.parametrize("state_dtype", ["fp32", "bf16", "factored"])
def test_round_trip_is_bit_equal(tmp_path, use_async, state_dtype):
    state, _ = make_state(state_dtype)
    o = state.opt_state
    if state_dtype == "bf16":
        assert o.mu[0].dtype == torch.bfloat16 and o.seed != 0
    if state_dtype == "factored":
        assert o.nu[0] is None and o.nu_row[0] is not None
    assert o.mu[3] is None                       # the frozen leaf
    mgr = CheckpointManager(str(tmp_path), use_async=use_async)
    mgr.save_best(state, {"epoch": 1, "val_loss": 0.5})
    target = fresh_like(state_dtype)
    params = list(target.params)
    restored, meta = mgr.restore_best(target)
    assert meta == {"epoch": 1, "val_loss": 0.5}
    assert restored is target
    assert all(p is q for p, q in zip(restored.params, params))
    assert_same(restored, state)
    # a structure that does not fit is refused, not cast
    other = "fp32" if state_dtype != "fp32" else "bf16"
    with pytest.raises(ValueError, match="checkpoint"):
        mgr.restore_best(fresh_like(other))


def test_payload_is_plain_and_loads_weights_only(tmp_path):
    state, _ = make_state("bf16")
    mgr = CheckpointManager(str(tmp_path), use_async=False)
    mgr.save_best(state, {"epoch": 0})
    payload = torch.load(os.path.join(mgr.best_path, checkpoint.STATE_FILE),
                         weights_only=True)
    assert list(payload["params"]) == state.names
    assert payload["step"] == 2 and payload["opt_state"]["count"] == 2
    assert payload["opt_state"]["mu"][3] is None
    assert payload["accum_grads"] is None


def _listing(d):
    # orbax names a dir in flight "<name>.orbax-checkpoint-tmp-<n>"
    names = sorted(n.split(".orbax-checkpoint-tmp")[0] for n in os.listdir(d))
    metas = {n: json.load(open(os.path.join(d, n)))
             for n in names if n.endswith("_meta.json")}
    return names, metas


def test_layout_and_meta_follow_jax(tmp_path):
    """The same calls on both managers leave the same names and meta
    files: fresh best dirs, the pointer flipping at wait(), the latest
    slot and its removal."""
    state, _ = make_state()
    jstate = {"w": np.zeros(3, np.float32)}
    p = CheckpointManager(str(tmp_path / "p"), use_async=True)
    j = j_checkpoint.CheckpointManager(str(tmp_path / "j"), use_async=True)
    seen = []
    for mgr, s in ((p, state), (j, jstate)):
        mgr.save_best(s, {"epoch": 1})
        mgr.wait()
        mgr.save_best(s, {"epoch": 2})
        before = _listing(mgr.directory)     # pointer still at best_1
        mgr.wait()
        after = _listing(mgr.directory)
        mgr.save_latest(s, {"epoch": 2, "preempted": True})
        latest = _listing(mgr.directory)
        mgr.clear_latest()
        seen.append((before, after, latest, _listing(mgr.directory)))
    assert seen[0] == seen[1]
    host = checkpoint._safe_hostname()
    assert host == j_checkpoint._safe_hostname()
    assert seen[0][1][1]["best_meta.json"] == {
        "epoch": 2, "_data": f"best_2_{host}-{os.getpid()}"}


def test_crash_mid_write_keeps_the_previous_best(tmp_path):
    s1, s2 = make_state(seed=1)[0], make_state(seed=2)[0]
    mgr = CheckpointManager(str(tmp_path), use_async=True)
    mgr.save_best(s1, {"epoch": 1})
    mgr.wait()
    mgr.save_best(s2, {"epoch": 2})
    # no wait: a process that died here leaves only what is on disk
    restored, meta = CheckpointManager(str(tmp_path)).restore_best(
        fresh_like("fp32"))
    assert meta["epoch"] == 1
    assert_same(restored, s1)
    restored, meta = mgr.restore_best(fresh_like("fp32"))
    assert meta["epoch"] == 2
    assert_same(restored, s2)


def test_failed_write_raises_at_wait_and_keeps_the_best(tmp_path,
                                                        monkeypatch):
    s1, s2 = make_state(seed=1)[0], make_state(seed=2)[0]
    mgr = CheckpointManager(str(tmp_path), use_async=True)
    mgr.save_best(s1, {"epoch": 1})
    mgr.wait()

    def full_disk(*a, **k):
        raise OSError("no space left on device")

    monkeypatch.setattr(checkpoint.torch, "save", full_disk)
    mgr.save_best(s2, {"epoch": 2})
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        mgr.wait()
    monkeypatch.undo()
    mgr.wait()                                   # the error was reported once
    assert sorted(os.listdir(tmp_path)) == ["best_1_%s-%d" % (
        checkpoint._safe_hostname(), os.getpid()), "best_meta.json"]
    restored, meta = mgr.restore_best(fresh_like("fp32"))
    assert meta["epoch"] == 1
    assert_same(restored, s1)


def test_gc_collects_dead_pid_orphans(tmp_path):
    state, _ = make_state()
    d = str(tmp_path)
    mgr = CheckpointManager(d, use_async=False)
    mgr.save_best(state, {"epoch": 1})
    referenced = os.path.basename(mgr.best_path)
    host = checkpoint._safe_hostname()
    dead_pid = subprocess.run([sys.executable, "-c",
                               "import os; print(os.getpid())"],
                              capture_output=True, text=True).stdout.strip()
    orphan = os.path.join(d, f"best_7_{host}-{dead_pid}")
    inflight = os.path.join(d, f"best_8_{host}-{os.getpid()}")
    foreign_fresh = os.path.join(d, f"best_9_othermachine-{dead_pid}")
    foreign_stale = os.path.join(d, f"best_10_othermachine-{dead_pid}")
    for path in (orphan, inflight, foreign_fresh, foreign_stale):
        os.makedirs(path)
    old = time.time() - 2 * CheckpointManager._GC_STALE_S
    os.utime(foreign_stale, (old, old))
    CheckpointManager(d)                         # start-up runs the GC
    assert not os.path.exists(orphan)
    assert os.path.exists(inflight) and os.path.exists(foreign_fresh)
    assert not os.path.exists(foreign_stale)
    restored, _ = mgr.restore_best(fresh_like("fp32"))
    assert os.path.basename(mgr.best_path) == referenced
    assert_same(restored, state)


@pytest.mark.parametrize("state_dtype", ["fp32", "bf16"])
def test_a_step_during_an_async_save_does_not_reach_it(tmp_path,
                                                       state_dtype):
    """The in-place trap: the optimizer rewrites parameters and moments in
    the tensors being saved; the save holds the state of its call."""
    state, tx = make_state(state_dtype)
    before = make_state(state_dtype)[0]          # the same values, apart
    mgr = CheckpointManager(str(tmp_path), use_async=True)
    mgr.save_best(state, {"epoch": 1})
    g = torch.Generator().manual_seed(5)
    tx.update(state.params, [torch.randn(s, generator=g) for s in SHAPES],
              state.opt_state, g)
    state.step += 1
    mgr.wait()
    assert not torch.equal(state.params[0], before.params[0])
    restored, _ = mgr.restore_best(fresh_like(state_dtype))
    assert_same(restored, before)
    # restoring into the live state rewinds its own tensors
    params = list(state.params)
    mgr.restore_best(state)
    assert all(p is q for p, q in zip(state.params, params))
    assert_same(state, before)


# ---- preemption and resume through the loop ---------------------------------

def _sigterm_at(n):
    calls = {"n": 0}

    def transform(rng, batch):
        calls["n"] += 1
        if calls["n"] == n:
            os.kill(os.getpid(), signal.SIGTERM)
        return batch

    return transform, calls


def test_sigterm_mid_epoch_saves_latest_and_stops(tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    transform, calls = _sigterm_at(7)
    _, state, logs, n_steps = port_mlp_run(mlp_params(), tmp_path, epoch=50,
                                           transform=transform)
    # 50 epochs of 15 steps without the drain; the signal at call 7 stops it
    assert n_steps < 15 and calls["n"] < 40
    assert signal.getsignal(signal.SIGTERM) is before
    assert logs[-1]["preempted"] is True
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.has_latest()
    _, meta = mgr.restore_latest(make_mlp_target())
    assert meta["preempted"] is True and meta["epoch"] == 0
    assert meta["step"] == n_steps and meta["batch"] == n_steps


def make_mlp_target():
    from tests.test_torch_loop import TinyMLP
    model = TinyMLP(mlp_params())
    tx = make_optimizer(lambda s: 0.0, 0.0, 1.0, state_dtype="fp32")
    return TrainState.create(model.parameters(), tx, use_accum=False,
                             names=[k for k, _ in model.named_parameters()])


def test_resume_prefers_latest_over_best(tmp_path):
    target = make_mlp_target()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_best(target, {"epoch": 0, "val_loss": 0.9})
    mgr.save_latest(target, {"epoch": 2, "batch": 0, "val_loss": 0.8,
                             "preempted": True})
    _, _, _, n_steps = port_mlp_run(mlp_params(), tmp_path, epoch=3,
                                    resume=True)
    assert n_steps == 15                         # epoch 2 only
    assert not mgr.has_latest()                  # cleared on success


def test_preempted_and_resumed_run_ends_where_an_uninterrupted_one_does(
        tmp_path):
    params = mlp_params()
    whole, _, _, n_whole = port_mlp_run(params, tmp_path / "whole", epoch=3)
    # SIGTERM at the third step of epoch 1 (dialog accumulation, class-
    # weighted loss), not a log point: epoch 0 takes 15 transform calls for
    # its steps and 12 for its three validations
    transform, _ = _sigterm_at(30)
    _, _, logs, n_first = port_mlp_run(params, tmp_path / "cut", epoch=3,
                                       transform=transform)
    assert logs[-1]["preempted"] and logs[-1]["epoch"] == 1
    resumed, _, _, n_rest = port_mlp_run(params, tmp_path / "cut", epoch=3,
                                         resume=True)
    assert n_first + n_rest == n_whole == 45
    for a, b in zip(resumed.parameters(), whole.parameters()):
        assert torch.equal(a, b)


def test_preempt_save_opt_out(tmp_path, monkeypatch):
    monkeypatch.setenv("MME_PREEMPT_SAVE", "0")
    before = signal.getsignal(signal.SIGTERM)
    port_mlp_run(mlp_params(), tmp_path, epoch=1)
    assert signal.getsignal(signal.SIGTERM) is before
    assert not CheckpointManager(str(tmp_path)).has_latest()


def test_chip_smoke_loop_phase_runs_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's phase 6 at the tiny size on the CPU: the loop trains
    both epoch parities, every saved state is stripped, the best restores
    bit for bit into fresh tensors, a step during a save does not reach
    it, and an eval-only run gives the same test pass (its own checks,
    which raise SystemExit)."""
    import dataclasses
    import chip_smoke
    from mme_tpu_torch.convert import init_params
    from mme_tpu_torch.models.fusion import TAVSpec
    for k, v in chip_smoke.LOOP_ENV.items():
        monkeypatch.setenv(k, v)
    spec = dataclasses.replace(TAVSpec(output_dim=7, dropout=0.1).tiny(),
                               share_audio_frontend=True)
    out = chip_smoke.loop_run(init_params(spec, 0), spec, "cpu",
                              str(tmp_path), text_len=16, audio_len=2000)
    assert out["epochs"] == [0, 1]          # one log point an epoch
    assert out["saved_states_stripped"] and not out["round_trip_diff"]
