"""The port's spans and counters (mme_tpu_torch/utils/profiling.py) and the
spans of the train step, the Predictor and the prefetch wait, on the CPU
under a CPU ``torch.profiler`` session: what is recorded, where it nests,
that it sits in the profiler's own timeline, and that tracing changes no
number.
"""

import itertools
import threading
import warnings

import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from mme_tpu_torch.data.dataset import ArrayDataset, batches
from mme_tpu_torch.data.prefetch import prefetch_batches
from mme_tpu_torch.serve import Predictor
from mme_tpu_torch.train import steps
from mme_tpu_torch.utils import profiling
from mme_tpu_torch.utils.profiling import STORE, count, span


@pytest.fixture(autouse=True)
def _empty_store():
    STORE.clear()
    yield
    STORE.clear()


def _traced():
    return profile(activities=[ProfilerActivity.CPU])


def _names(recs):
    return [r.name for r in recs]


class Tiny(nn.Module):
    """``model(batch, rng=None) -> logits`` over a feature ``x`` [B, 4]."""

    def __init__(self, seed: int = 0):
        super().__init__()
        with torch.random.fork_rng():
            torch.manual_seed(seed)
            self.fc = nn.Linear(4, 3)

    def forward(self, batch, rng=None):
        return self.fc(batch["x"])


def _batch(n=6, seed=1):
    r = np.random.RandomState(seed)
    return ({"x": r.randn(n, 4).astype(np.float32)},
            (np.arange(n) % 3).astype(np.int64))


def test_off_path_records_nothing_and_calls_no_profiler(monkeypatch):
    def refused(*a, **k):
        raise AssertionError("a profiler call with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    assert not torch.autograd._profiler_enabled()
    with span("mme.a") as a, span("mme.b") as b:
        count("host_syncs")
    assert a is None and b is None and span("mme.a") is span("mme.c")
    assert STORE.records() == []


def test_nested_spans_carry_parent_thread_and_profiler_stamps():
    """A session records on the thread that opened it (and the threads
    torch hands its state to): a thread of the caller's records nothing."""
    seen = {}

    def other():
        with span("mme.other") as rec:
            seen["rec"] = rec

    with _traced() as prof:
        # the profiler's first range of a process costs a millisecond
        with span("mme.warm"):
            pass
        with span("mme.outer") as outer:
            with span("mme.inner") as inner:
                torch.ones(8).sum()
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=10)
    assert not t.is_alive()
    recs = {r.name: r for r in STORE.records()}
    assert set(recs) == {"mme.warm", "mme.outer", "mme.inner"}
    assert seen["rec"] is None
    assert recs["mme.outer"] is outer and recs["mme.inner"] is inner
    assert outer.parent is None and inner.parent == outer.id
    assert inner.thread == outer.thread == threading.get_ident()
    assert outer.start_ns <= inner.start_ns < inner.end_ns <= outer.end_ns
    kineto = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("mme.")}
    assert set(kineto) == set(recs)
    for name, rec in recs.items():
        e = kineto[name]
        assert abs(e.start_ns() - rec.start_ns) < 1_000_000, name
        assert abs(e.start_ns() + e.duration_ns() - rec.end_ns) < 1_000_000


def test_counts_go_to_the_innermost_span_and_syncs_stay_silent(capfd):
    with _traced():
        with span("mme.outer") as outer:
            count("rows", 3)
            with span("mme.inner") as inner:
                count("rows")
                for _ in range(2):   # the same line twice: both count
                    warnings.warn(profiling.SYNC_WARNING
                                  + " (Triggered internally)")
            count("rows")
            with pytest.warns(UserWarning, match="another warning"):
                warnings.warn("another warning")
    assert outer.counts == {"rows": 4}
    assert inner.counts == {"rows": 1, profiling.HOST_SYNCS: 2}
    assert profiling.SYNC_WARNING not in capfd.readouterr().err
    assert warnings.showwarning is not profiling._SYNCS._show
    count("rows")   # no span open: counted nowhere
    assert outer.counts == {"rows": 4}


def test_ring_keeps_the_newest_and_counts_what_it_drops():
    ring = profiling.SpanStore(capacity=3)
    for i in range(5):
        ring.open(f"s{i}", None)
    assert _names(ring.records()) == ["s2", "s3", "s4"]
    assert ring.dropped == 2
    ring.clear()
    assert ring.records() == [] and ring.dropped == 0


def _train_once(trace: bool):
    model = Tiny()
    tx = steps.make_optimizer(lambda s: 1e-2, 0.01, 1.0, state_dtype="fp32")
    state = steps.TrainState.create(model.parameters(), tx, use_accum=False)
    step = steps.make_train_step(model, tx, num_classes=3)
    feats, labels = _batch()
    args = (feats, labels, np.ones(6, np.float32), np.ones(3, np.float32),
            1.0, True, 7)
    if trace:
        with _traced():
            _, loss, _, _ = step(state, *args)
    else:
        _, loss, _, _ = step(state, *args)
    return loss, [p.detach().clone() for p in model.parameters()]


def test_train_step_records_its_four_phases_in_order():
    _train_once(trace=True)
    recs = STORE.records()
    assert _names(recs) == ["mme.train.step", "mme.train.inputs",
                            "mme.train.forward", "mme.train.backward",
                            "mme.train.optimizer"]
    unit, *phases = recs
    assert all(r.parent == unit.id for r in phases)
    ends = [unit.start_ns] + [t for r in phases
                              for t in (r.start_ns, r.end_ns)]
    assert ends == sorted(ends) and phases[-1].end_ns <= unit.end_ns


def _predictor():
    return Predictor(Tiny(), batch_size=4, device="cpu")


def test_predict_dataset_records_each_chunk_with_its_phases():
    feats, labels = _batch()
    ds = ArrayDataset(feats, labels)
    with _traced():
        rows = list(_predictor().predict_dataset(
            ds, batch_transform=lambda rng, chunk: chunk))
    assert len(rows) == 6
    recs = STORE.records()
    phases = ["mme.serve.h2d", "mme.serve.transform", "mme.serve.forward",
              "mme.serve.readback"]
    assert _names(recs) == (["mme.serve.chunk"] + phases) * 2
    for unit in (recs[0], recs[5]):
        kids = [r for r in recs if r.parent == unit.id]
        assert _names(kids) == phases
    STORE.clear()
    with _traced():
        _predictor()(feats)
    assert _names(STORE.records()) == ([
        "mme.serve.chunk", "mme.serve.h2d", "mme.serve.forward",
        "mme.serve.readback"] * 2)


def test_prefetch_records_one_wait_per_batch():
    feats, labels = _batch(12)
    ds = ArrayDataset(feats, labels)
    with _traced():
        it = prefetch_batches(batches(ds, np.arange(12), 4), device="cpu")
        got = list(itertools.islice(it, 3))
        it.close()
    assert len(got) == 3
    recs = STORE.records()
    assert _names(recs) == ["mme.prefetch.wait"] * 3
    assert all(r.parent is None and r.end_ns >= r.start_ns for r in recs)


def test_tracing_changes_no_number():
    loss_off, params_off = _train_once(trace=False)
    loss_on, params_on = _train_once(trace=True)
    assert torch.equal(loss_off, loss_on)
    assert all(torch.equal(a, b) for a, b in zip(params_off, params_on))
    feats, _ = _batch()
    preds_off, probs_off = _predictor()(feats)
    with _traced():
        preds_on, probs_on = _predictor()(feats)
    assert np.array_equal(preds_off, preds_on)
    assert np.array_equal(probs_off, probs_on)
