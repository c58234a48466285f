"""The program's own spans and counters (``mme_tpu_torch/utils/profiling.py``:
``STORE``), reduced to the traced window's units for the per-layer readers.

The program records its spans while a profiler session records, so a
traced run leaves in the store the units of ``trace.traced``'s first
window (``summary.units`` of them, the device alone recorded) followed by
the one unit of its second window (the host recorded too). The readers
take the first ``summary.units`` unit spans: the window whose times and
counts the summary holds. A unit owns the spans under it and, on its
thread, the spans outside any unit that end after the unit before it
ended: a prefetch wait belongs to the step that follows it.

A program without the store (one that records no spans) gives None, as
does a store holding fewer units than the window ran.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional


@dataclasses.dataclass
class Unit:
    """One unit span, the spans under it (``inside``, the unit's own
    record first) and the spans before it that it owns (``before``)."""

    span: object
    inside: List[object]
    before: List[object]


def records() -> Optional[list]:
    """The program's span records, oldest first; None without a store."""
    try:
        from mme_tpu_torch.utils.profiling import STORE
    except ImportError:
        return None
    return STORE.records()


def window_units(recs: list, name: str, n: int) -> Optional[List[Unit]]:
    """The first ``n`` spans called ``name`` in ``recs``, each with what it
    owns (module docstring); None if there are fewer, or ``n`` < 1."""
    recs = [r for r in recs if r.end_ns]   # spans still open own nothing
    tops = [r for r in recs if r.name == name]
    if n < 1 or len(tops) < n:
        return None
    by_id = {r.id: r for r in recs}

    def unit_of(r):
        """The unit span ``r`` is or lies under, else None."""
        while r is not None and r.name != name:
            r = by_id.get(r.parent)
        return r

    units: Dict[int, Unit] = {u.id: Unit(u, [], []) for u in tops[:n]}
    by_thread: Dict[int, list] = defaultdict(list)
    for u in tops:
        by_thread[u.thread].append(u)
    for r in recs:
        top = unit_of(r)
        if top is not None:     # a unit after the window owns its own
            if top.id in units:
                units[top.id].inside.append(r)
            continue
        mine = by_thread[r.thread]
        k = next((k for k, u in enumerate(mine) if u.end_ns >= r.end_ns),
                 None)
        # the next unit of its thread, unless the span began before the
        # unit ahead of that one ended (a span around units)
        if k is not None and mine[k].id in units and not (
                k and r.start_ns < mine[k - 1].end_ns):
            units[mine[k].id].before.append(r)
    return [units[u.id] for u in tops[:n]]


def _units(layer, name: str) -> Optional[List[Unit]]:
    summary = layer.get("summary")
    recs = records()
    if summary is None or recs is None:
        return None
    return window_units(recs, name, int(summary.units))


def mean_ms(layer, unit: str, span: str) -> Optional[float]:
    """Host ms per unit in the spans called ``span`` that the window's
    units own."""
    units = _units(layer, unit)
    if units is None:
        return None
    ns = sum(r.duration_ns for u in units for r in u.inside + u.before
             if r.name == span)
    return ns / 1e6 / len(units)


def mean_count(layer, unit: str, counter: str) -> Optional[float]:
    """Counter ``counter`` per unit, summed over each unit span and the
    spans under it."""
    units = _units(layer, unit)
    if units is None:
        return None
    return sum(r.counts.get(counter, 0) for u in units
               for r in u.inside) / len(units)
