"""Reduce a ``torch.profiler`` trace of the window to what the per-layer
metrics read.

The window is the host range ``portbench.window`` (``record_function``);
every device operation (kernel, copy, set) that starts inside it counts,
by name, but those launched inside a ``portbench.sample`` range: the
harness's copies of the requests it keeps for the check, told by the
correlation id of the runtime call (``cuda…``) that launched them.  ``busy_s`` is the union of their intervals, clipped to the
window; the idle gaps are the rest, each named by what the host was doing
at its middle (the innermost host operation open then, with its parent).

Which kernels are the port's own is read from the program's kernel
sources: the ``__global__`` functions of each library's ``.cu`` files
(``repro_torch.kernels._build.KERNELS``).  Which are matrix products is
decided by name, as ``chip_smoke.py``'s profile split decides it
(``GEMM_NAMES``, a frozen copy).
"""
from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Dict, List, Set, Tuple

WINDOW = "portbench.window"
STEP = "portbench.step"
SAMPLE = "portbench.sample"
# kernel-name fragments of cuBLAS / CUTLASS matrix products
GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma", "cublas")
# device-timeline entries that are not device work
NOT_DEVICE_WORK = ("Command Buffer Full",)

_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)"
                     r"\s*)?(?:void\s+)?([A-Za-z_]\w*)\s*\(")


def port_kernels() -> Dict[str, Set[str]]:
    """{library: its ``__global__`` function names} of the program."""
    from repro_torch.kernels import _build
    out = {}
    for lib, kern in _build.KERNELS.items():
        names = set()
        for src in kern.csrc.glob("*.cu"):
            names |= set(_GLOBAL.findall(src.read_text()))
        out[lib] = names
    return out


def _word(name: str, kernel_name: str) -> bool:
    return re.search(rf"\b{re.escape(name)}\b", kernel_name) is not None


@dataclasses.dataclass
class TraceSummary:
    """What one traced window holds."""
    window_s: float
    busy_s: float
    steps: int
    kernels: Dict[str, List[float]]      # name -> [device seconds, count]
    gaps: Dict[str, float]               # host activity -> idle seconds
    port: Dict[str, Set[str]]            # library -> __global__ names
    sample_ops: int = 0                  # the harness's copies, left out
    sample_s: float = 0.0

    def library_of(self, kernel_name: str):
        """The port library whose kernel ``kernel_name`` is, or None."""
        for lib, names in self.port.items():
            if any(_word(n, kernel_name) for n in names):
                return lib
        return None

    def is_product(self, kernel_name: str) -> bool:
        return (self.library_of(kernel_name) is None
                and any(g in kernel_name.lower() for g in GEMM_NAMES))

    def launches(self, library: str) -> Tuple[float, int]:
        """(device seconds, launches) of the port library's kernels."""
        s = n = 0
        for name, (sec, count) in self.kernels.items():
            if self.library_of(name) == library:
                s += sec
                n += count
        return s, int(n)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:200], v[0]] for n, v in ops],
                "idle_gaps": [[n[:200], s] for n, s in gaps]}


def _union(intervals: List[Tuple[float, float]]):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged


@dataclasses.dataclass
class Event:
    """One entry of the trace: times in microseconds."""
    name: str
    on_device: bool
    start: float
    end: float
    thread: int
    annotation: bool = False
    corr: int = 0            # correlation id: a launch and what it launched


def events_of(prof) -> List[Event]:
    """The profile's events, read from the profiler's raw (kineto) list:
    building ``prof.events()``' tree takes some forty times as long."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        annotation = getattr(e, "is_user_annotation", None)
        out.append(Event(e.name(), e.device_type() == DeviceType.CUDA,
                         start, start + e.duration_ns() / 1e3,
                         e.start_thread_id(),
                         bool(annotation()) if annotation else False,
                         int(e.correlation_id())))
    return out


def _parents(host: List[Event]) -> List[int]:
    """For host events sorted by start, the index of the innermost event
    that encloses each one (-1 for none)."""
    parents, stack = [], []
    for i, e in enumerate(host):
        while stack and host[stack[-1]].end <= e.start:
            stack.pop()
        parents.append(stack[-1] if stack else -1)
        stack.append(i)
    return parents


def _host_name(t: float, host: List[Event], starts, parents) -> str:
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and host[i].end < t:
        i = parents[i]
    if i < 0:
        return "(no host operation)"
    p = parents[i]
    return f"{host[p].name} > {host[i].name}" if p >= 0 else host[i].name


def reduce(prof, steps: int, port) -> TraceSummary:
    """The ``TraceSummary`` of ``prof`` (a finished ``torch.profiler``
    profile of a window of ``steps`` steps)."""
    return reduce_events(events_of(prof), steps, port)


def reduce_events(events: List[Event], steps: int, port) -> TraceSummary:
    """The ``TraceSummary`` of a window's ``events``."""
    windows = [e for e in events if e.name == WINDOW and not e.on_device]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    win = max(windows, key=lambda e: e.end - e.start)
    w0, w1 = win.start, win.end
    samples = [(e.start, e.end) for e in events
               if e.name == SAMPLE and not e.on_device]
    launched = {e.corr for e in events
                if not e.on_device and e.name.startswith("cu") and e.corr
                and any(a <= e.start < b for a, b in samples)}
    kernels: Dict[str, List[float]] = {}
    spans, host = [], []
    sample_ops, sample_s = 0, 0.0
    for e in events:
        if e.on_device:
            if e.annotation or e.name.startswith("portbench.") \
                    or e.name.startswith(NOT_DEVICE_WORK):
                continue
            if not w0 <= e.start < w1:
                continue
            if e.corr in launched:
                sample_ops += 1
                sample_s += (e.end - e.start) / 1e6
                continue
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += (e.end - e.start) / 1e6
            k[1] += 1
            spans.append((e.start, min(e.end, w1)))
        elif e.thread == win.thread and e is not win and e.end > w0 \
                and e.start < w1:
            host.append(e)
    merged = _union(spans)
    busy = sum(b - a for a, b in merged)
    host.sort(key=lambda e: (e.start, -e.end))
    starts = [e.start for e in host]
    parents = _parents(host)
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            name = _host_name((a + b) / 2, host, starts, parents)
            gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    return TraceSummary(window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6,
                        steps=steps, kernels=kernels, gaps=gaps, port=port,
                        sample_ops=sample_ops, sample_s=sample_s)
