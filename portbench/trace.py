"""The benchmark's own instruments: wrappers around the calls into the
program's layers, and the reading of a torch.profiler trace.

``Probe.wrap(module, name, label)`` replaces ``module.name`` by a wrapper
that keeps the call's result for the driver (``last[label]``) and, when
timing is on, records a CUDA event pair around the call on the current
stream (``device_ms``) and, where asked, the host milliseconds of the call
between two synchronizations (``host_ms``).  Event pairs are read only
after the window, so the timed path gains no synchronization but that of
``host_ms``.  ``Probe.restore()`` puts every original back.

``analyse(prof)`` reduces a trace to the device's busy seconds inside
the ``portbench.window`` span (the union of every kernel, copy and set's
interval), the device operations that took the most time, the idle gaps
by the innermost host span open at their start, and the count of records
of each kernel name.
"""

import time

import torch

SPAN_PREFIXES = ("tardis.", "portbench.")
WINDOW_SPAN = "portbench.window"


class Probe:
    def __init__(self, timing: bool):
        self.timing = timing
        self.last: dict = {}
        self.calls: dict = {}
        self.pairs: dict = {}  # label -> [(start event, end event)]
        self.host: dict = {}  # label -> [ms]
        self._saved = []

    def wrap(self, owner, name: str, label: str, host: bool = False):
        if label in self.calls:
            return  # one wrapper a label
        original = getattr(owner, name)
        self._saved.append((owner, name, original))
        pairs = self.pairs.setdefault(label, [])
        host_ms = self.host.setdefault(label, [])
        self.calls[label] = 0

        def wrapper(*args, **kwargs):
            self.calls[label] += 1
            if not self.timing:
                out = original(*args, **kwargs)
                self.last[label] = out
                return out
            if host:
                torch.cuda.synchronize()
                h0 = time.perf_counter()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = original(*args, **kwargs)
            b.record()
            if host:
                torch.cuda.synchronize()
                host_ms.append((time.perf_counter() - h0) * 1e3)
            pairs.append((a, b))
            self.last[label] = out
            return out

        setattr(owner, name, wrapper)

    def device_ms(self, label: str) -> list:
        """Milliseconds between each call's event pair (after a
        synchronize)."""
        return [a.elapsed_time(b) for a, b in self.pairs.get(label, [])]

    def restore(self):
        for owner, name, original in reversed(self._saved):
            setattr(owner, name, original)
        self._saved.clear()


def _events(prof):
    return prof.profiler.kineto_results.events()


def _is_device_type(e) -> bool:
    dt = e.device_type()
    return getattr(dt, "name", str(dt)).upper().endswith("CUDA")


def _is_device(e) -> bool:
    return (_is_device_type(e) and not e.is_user_annotation()
            and not e.name().startswith(SPAN_PREFIXES))


def analyse(prof) -> dict:
    dev, spans, by_name = [], [], {}
    events = list(_events(prof))
    window = [e for e in events if e.name() == WINDOW_SPAN
              and not _is_device_type(e)]
    if not window:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    t0_ns = window[0].start_ns()
    t1_ns = t0_ns + window[0].duration_ns()
    for e in events:
        s = e.start_ns()
        f = s + e.duration_ns()
        if _is_device(e):
            if f <= t0_ns or s >= t1_ns:
                continue
            name = e.name()
            dev.append((max(s, t0_ns), min(f, t1_ns)))
            tot, n = by_name.get(name, (0.0, 0))
            by_name[name] = (tot + (f - s) * 1e-9, n + 1)
        elif (e.name().startswith(SPAN_PREFIXES)
              and e.name() != WINDOW_SPAN):
            spans.append((s, f, e.name()))
    dev.sort()
    busy, gaps = 0, []
    cur_s = cur_f = None
    prev_end = t0_ns
    for s, f in dev:
        if cur_f is None or s > cur_f:
            if cur_f is not None:
                busy += cur_f - cur_s
            if s > prev_end:
                gaps.append((prev_end, s))
            cur_s, cur_f = s, f
        else:
            cur_f = max(cur_f, f)
        prev_end = max(prev_end, f)
    if cur_f is not None:
        busy += cur_f - cur_s
    if prev_end < t1_ns:
        gaps.append((prev_end, t1_ns))
    # sweep: span starts, gap starts, span ends in time order; the span
    # on top of the stack is the innermost one open
    marks = [(s, 0, i) for i, (s, _, _) in enumerate(spans)]
    marks += [(f, 2, i) for i, (_, f, _) in enumerate(spans)]
    marks += [(gs, 1, i) for i, (gs, _) in enumerate(gaps)]
    marks.sort()
    stack, idle_by = [], {}
    for _, kind, i in marks:
        if kind == 0:
            stack.append(i)
        elif kind == 2:
            if stack and stack[-1] == i:
                stack.pop()
            elif i in stack:
                stack.remove(i)
        else:
            name = spans[stack[-1]][2] if stack else "no span"
            gs, gf = gaps[i]
            idle_by[name] = idle_by.get(name, 0.0) + (gf - gs) * 1e-9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return dict(
        busy_s=busy * 1e-9,
        window_s=(t1_ns - t0_ns) * 1e-9,
        device_ops=[[n, v[0]] for n, v in ops[:10]],
        idle_gaps=sorted(([n, v] for n, v in idle_by.items()),
                         key=lambda kv: -kv[1])[:10],
        records={n: v[1] for n, v in by_name.items()},
    )
