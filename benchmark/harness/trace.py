"""The traced sub-window: a ``torch.profiler`` recording kept in memory, and
its reduction to what the per-layer readers and ``breakdown`` read.

The raw events are read from the profiler's results directly (no event
tree, no Chrome file): device intervals (kernels, copies, sets) and the
host's events of the thread that drives the window. Busy time is the union
of the device intervals inside the window; an idle gap is named by what the
host was doing at its middle: the innermost harness span (``bench.*``) and
the innermost host event under it.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

COPY_PREFIXES = ("Memcpy", "Memset")
WINDOW = "bench.window"    # the span that bounds the traced window

# kernel-name fragments → family, first match wins (a frozen copy of the
# port's profile_serve.FAMILIES, with "conv" matched as cuDNN names it so
# that "convert" kernels stay out)
FAMILIES = (("flash_fwd", "flash_fwd (K1)"),
            ("flash_bwd", "flash_bwd (K2)"),
            ("adam_update", "adam_update (K3)"),
            ("mme_ln_fwd", "layer_norm_fwd (K4a)"),
            ("mme_ln_bwd", "layer_norm_bwd (K4b)"),
            ("mlp_fwd", "fused_mlp_fwd (K5a)"),
            ("mlp_bwd", "fused_mlp_bwd (K5b)"),
            ("mlp_dual", "fused_mlp_bwd (K5b)"),
            ("mlp_gemm", "mlp_gemm (K5a; K5b dx, dW)"),
            ("dgrad", "conv backward"), ("wgrad", "conv backward"),
            ("convolve", "conv"), ("conv2d", "conv"), ("conv1d", "conv"),
            ("_conv", "conv"), ("cudnn", "conv"), ("fprop", "conv"),
            ("gemm", "matmul"), ("xmma", "matmul"), ("cutlass", "matmul"),
            ("nvjet", "matmul"),
            ("Memcpy", "memcpy"), ("Memset", "memset"), ("copy", "copy/cast"),
            ("reduce", "reduction"), ("softmax", "reduction"))


def kernel_family(name: str) -> str:
    low = name.lower()
    for frag, fam in FAMILIES:
        if frag.lower() in low:
            return fam
    return "elementwise/other"


@dataclasses.dataclass
class Summary:
    """What one traced sub-window held. Times in seconds."""

    window_s: float
    busy_s: float
    units: int                                  # steps, chunks or requests
    kernels: Dict[str, List[float]]             # name → [count, seconds]
    copies: Dict[str, List[float]]              # name → [count, seconds]
    gaps: Dict[str, float]                      # host activity → seconds

    def family_s(self, family: str) -> float:
        return sum(s for n, (_, s) in self.kernels.items()
                   if kernel_family(n) == family)

    def kernels_matching(self, fragment: str) -> Tuple[int, float]:
        hits = [(c, s) for n, (c, s) in self.kernels.items()
                if fragment in n]
        return int(sum(c for c, _ in hits)), sum(s for _, s in hits)

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops = {n: s for n, (_, s) in {**self.kernels, **self.copies}.items()}
        return {
            "device_ops": [[n[:120], s] for n, s in sorted(
                ops.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[n[:120], s] for n, s in sorted(
                self.gaps.items(), key=lambda kv: -kv[1])[:top]]}


def union(intervals: List[Tuple[int, int]], lo: int, hi: int
          ) -> List[Tuple[int, int]]:
    """The disjoint union of [start, end) intervals, clipped to [lo, hi]."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def name_gaps(gaps: List[Tuple[int, int]],
              host: List[Tuple[int, int, str]]) -> Dict[str, float]:
    """Seconds of idle device time by host activity: each gap is named by
    the innermost ``bench.*`` span and the innermost other host event
    around its middle. Host events of one thread nest, so one sweep with a
    stack of the open events finds them."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    out: Dict[str, float] = defaultdict(float)
    stack: List[Tuple[int, int, str]] = []
    j = 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (g0 + g1) // 2
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] <= host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        span = next((n for _, e, n in reversed(stack)
                     if e >= mid and n.startswith("bench.")), "")
        op = next((n for _, e, n in reversed(stack)
                   if e >= mid and not n.startswith("bench.")), "")
        out[f"{span or 'outside any span'} / {op or 'python'}"] += (
            (g1 - g0) / 1e9)
    return dict(out)


def reduce(device: List[Tuple[int, int, str]],
           host: List[Tuple[int, int, str]], lo: int, hi: int,
           units: int) -> Summary:
    """Device events (start ns, end ns, name), the driving thread's host
    events, the window [lo, hi] in ns and the units it held."""
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    copies: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for s, e, name in device:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        into = copies if name.startswith(COPY_PREFIXES) else kernels
        into[name][0] += 1
        into[name][1] += (e - s) / 1e9
    busy = union([(s, e) for s, e, _ in device], lo, hi)
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = e
    if hi > t:
        gaps.append((t, hi))
    return Summary(window_s=(hi - lo) / 1e9,
                   busy_s=sum(e - s for s, e in busy) / 1e9, units=units,
                   kernels=dict(kernels), copies=dict(copies),
                   gaps=name_gaps(gaps, host))


def _annotation(event) -> bool:
    try:
        return bool(event.is_user_annotation())
    except (AttributeError, RuntimeError):
        return False


class Window:
    """``with Window(device) as w: ...; w.units = n`` traces the block;
    ``w.summary`` is its reduction.

    ``host=False`` records the device alone: the profiler's cost per
    recorded host operation (several µs, on some 30 000 launches a train
    step) would otherwise stretch the host's share of the window, so busy
    time, idle share and kernel times come from such a window, bounded by
    its first and last device operation. ``host=True`` records the host's
    operations too, for naming the idle gaps. On a device without CUDA it
    records the host alone (busy time 0)."""

    def __init__(self, device, host: bool = True):
        self.device = torch.device(device)
        self.host = host or self.device.type != "cuda"
        self.units = 0
        self.summary: Optional[Summary] = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] if self.host else []
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._sync()
        self.span = torch.profiler.record_function(WINDOW)
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.span.__exit__(None, None, None)
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = self._reduce()
        return False

    def _reduce(self) -> Summary:
        device, host_by_tid = [], defaultdict(list)
        lo = hi = None
        for e in self.prof.profiler.kineto_results.events():
            s = e.start_ns()
            item = (s, s + e.duration_ns(), e.name())
            if str(e.device_type()).endswith("CUDA"):
                # a span's range on the device is no device work
                if not (item[2].startswith("bench.")
                        or _annotation(e)):
                    device.append(item)
            else:
                host_by_tid[e.start_thread_id()].append(item)
                if item[2] == WINDOW:
                    lo, hi = item[0], item[1]
        if lo is None:
            lo = min((s for s, _, _ in device), default=0)
            hi = max((e for _, e, _ in device), default=lo)
        # the driving thread: the one holding the harness's spans
        host = max(host_by_tid.values(), default=[], key=lambda ev: sum(
            1 for _, _, n in ev if n.startswith("bench.")))
        return reduce(device, host, lo, hi, self.units)


def traced(device, run_units, units: int) -> Summary:
    """``run_units(n)`` traced: ``units`` of it with the device alone
    recorded (the summary's times and counts), then one more with the host
    too (the summary's names of the idle gaps)."""
    with Window(device, host=False) as win:
        run_units(units)
        win.units = units
    with Window(device, host=True) as named:
        run_units(1)
        named.units = 1
    win.summary.gaps = named.summary.gaps
    return win.summary
