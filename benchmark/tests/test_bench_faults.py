"""A run at a small size on the CPU, the harness's look for a chip
skipped: sound, it is correct under each cell's limits; with the timed
path broken underneath it is not, once for each fault the cell can have
(a step that leaves the state unchanged, half of the batch left out, an
answer altered where it is produced). The controls and planted faults put
in the program's place fail a limit too (TF32 has no effect on the CPU;
the card's readings are in PERF.md)."""

import time

import numpy as np
import pytest

from conftest import tiny_cell

TRAIN = ["tav.train.b8", "text_video.train.b8"]
SERVE = ["tav.serve.b32"]


def _run(name: str, seed: int = 2**31 + 3) -> dict:
    import run
    return run.execute(tiny_cell(name), seed, 0.3, False, "cpu",
                       time.time(), run.declared())


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_sound_run_is_correct(name):
    line = _run(name)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("name", TRAIN)
def test_unchanged_state_is_caught(name, monkeypatch):
    from mme_tpu_torch.train import optim
    monkeypatch.setattr(optim.Optimizer, "update",
                        lambda self, params, grads, state, generator=None:
                        state)
    line = _run(name)
    assert not line["correct"]
    assert line["checks"]["grad_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_half_batch_is_caught(name, monkeypatch):
    from mme_tpu_torch.train import losses, steps
    whole = losses.cross_entropy

    def half(logits, labels, class_weights=None, sample_mask=None):
        n = logits.shape[0] // 2
        return whole(logits[:n], labels[:n], class_weights,
                     None if sample_mask is None else sample_mask[:n])

    monkeypatch.setattr(losses, "cross_entropy", half)
    monkeypatch.setattr(steps, "cross_entropy", half)
    line = _run(name)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", SERVE)
def test_altered_answer_is_caught(name, monkeypatch):
    from mme_tpu_torch import serve
    run_chunk = serve.Predictor._run

    def altered(self, batch):
        preds, probs = run_chunk(self, batch)
        probs = probs.copy()
        order = np.argsort(-probs[0])
        probs[0, order[[0, -1]]] = probs[0, order[[-1, 0]]]
        return preds, probs

    monkeypatch.setattr(serve.Predictor, "_run", altered)
    line = _run(name)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", TRAIN + ["tav.serve.b32"])
def test_controls_fail_a_limit(name):
    import control
    c = tiny_cell(name)
    for reading, numbers in control.readings(c, 5, "cpu").items():
        if reading == "tf32":
            continue
        assert any(v > c["limits"][k] for k, v in numbers.items()
                   if k in c["limits"]), (reading, numbers)
