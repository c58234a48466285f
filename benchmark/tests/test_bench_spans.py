"""The reader of the program's spans (``harness/spans.py``) on stores built
by hand: which units make the window, what each owns, the per-unit sums,
and None where there are too few units or no store; then the nine
readers through a traced run of the small cells on the CPU."""

import time
from types import SimpleNamespace

import pytest

from conftest import tiny_cell
from harness import spans
from mme_tpu_torch.utils.profiling import SpanRecord

T = 7          # the driving thread
MS = 1_000_000


class Store:
    """Records as the program's store holds them, oldest first."""

    def __init__(self):
        self.recs = []

    def add(self, name, start_ms, end_ms, parent=None, thread=T, **counts):
        rec = SpanRecord(len(self.recs), name, parent, thread,
                         start_ms * MS, end_ms * MS, dict(counts))
        self.recs.append(rec)
        return rec.id


def _steps(store, starts, syncs=2):
    """One prefetch wait, then a step with its four phases, per start."""
    for t in starts:
        store.add("mme.prefetch.wait", t, t + 1)
        u = store.add("mme.train.step", t + 2, t + 20, host_syncs=1)
        store.add("mme.train.inputs", t + 2, t + 4, u, host_syncs=syncs)
        store.add("mme.train.forward", t + 4, t + 9, u)
        store.add("mme.train.backward", t + 9, t + 13, u)
        store.add("mme.train.optimizer", t + 13, t + 19, u)


def _layer(units, kind="train"):
    return {"kind": kind, "summary": SimpleNamespace(units=units)}


def test_window_takes_the_first_units_and_what_each_owns():
    s = Store()
    _steps(s, [0, 30, 60])      # two traced units, then the host's one
    got = spans.window_units(s.recs, "mme.train.step", 2)
    assert [u.span.start_ns // MS for u in got] == [2, 32]
    for u, t in zip(got, (0, 30)):
        assert [r.name for r in u.inside] == [
            "mme.train.step", "mme.train.inputs", "mme.train.forward",
            "mme.train.backward", "mme.train.optimizer"]
        assert [(r.name, r.start_ns // MS) for r in u.before] == [
            ("mme.prefetch.wait", t)]


def test_spans_of_other_threads_around_units_or_open_own_nothing():
    s = Store()
    s.add("mme.epoch", 0, 100)                     # around the units
    _steps(s, [10, 40])
    s.add("mme.prefetch.wait", 5, 8, thread=T + 1)   # another thread
    s.add("mme.train.step", 90, 0)                  # still open
    got = spans.window_units(s.recs, "mme.train.step", 2)
    assert [[r.name for r in u.before] for u in got] == [
        ["mme.prefetch.wait"], ["mme.prefetch.wait"]]
    assert spans.window_units(s.recs, "mme.train.step", 3) is None


@pytest.mark.parametrize("units,forward,wait,syncs", [
    (1, 5.0, 1.0, 3.0), (2, 5.0, 1.0, 3.0), (3, 5.0, 1.0, 3.0)])
def test_per_unit_sums(monkeypatch, units, forward, wait, syncs):
    s = Store()
    _steps(s, [0, 30, 60, 90])
    monkeypatch.setattr(spans, "records", lambda: s.recs)
    layer = _layer(units)
    assert spans.mean_ms(layer, "mme.train.step",
                         "mme.train.forward") == forward
    assert spans.mean_ms(layer, "mme.train.step",
                         "mme.prefetch.wait") == wait
    assert spans.mean_count(layer, "mme.train.step", "host_syncs") == syncs


def test_none_with_too_few_units_or_no_store(monkeypatch):
    s = Store()
    _steps(s, [0])
    monkeypatch.setattr(spans, "records", lambda: s.recs)
    assert spans.mean_ms(_layer(2), "mme.train.step",
                         "mme.train.forward") is None
    assert spans.mean_ms(_layer(0), "mme.train.step",
                         "mme.train.forward") is None
    assert spans.mean_count(_layer(1), "mme.serve.chunk",
                            "host_syncs") is None
    monkeypatch.setattr(spans, "records", lambda: None)
    assert spans.mean_ms(_layer(1), "mme.train.step",
                         "mme.train.forward") is None


TRAIN = ("forward_host_ms.train", "backward_host_ms.train",
         "optimizer_host_ms.train", "inputs_host_ms.train",
         "prefetch_wait_ms.train", "host_syncs.train")
SERVE = ("forward_host_ms.serve", "readback_wait_ms.serve",
         "host_syncs.serve")


@pytest.mark.parametrize("cell,names", [("tav.train.b8", TRAIN),
                                        ("tav.serve.b32", SERVE)])
def test_readers_read_a_traced_run(cell, names):
    """The small cell traced on the CPU: every reader of the cell reads a
    number (the CPU makes no CUDA call, so no host sync)."""
    import run
    from mme_tpu_torch.utils.profiling import STORE
    STORE.clear()
    line = run.execute(tiny_cell(cell), 2**31 + 11, 0.2, True, "cpu",
                       time.time(), run.declared())
    for name in names:
        value = line["metrics"][name]["value"]
        assert value >= 0, name
        if not name.startswith("host_syncs"):
            assert value > 0, name
