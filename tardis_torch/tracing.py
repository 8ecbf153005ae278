"""The program's one trace recorder: spans, kernel launches and counters.

Every ``tardis.*`` span and every hand-written kernel's launch count goes
through this module:

- ``span(name)``: a ``with`` block, or a function's decorator, that
  opens ``torch.profiler.record_function(name)``, so a profiler trace
  shows it under its name, and records it here (name, parent, host start
  and end on ``time.perf_counter_ns()``, the iteration it belongs to);
- ``launch(kernel, variant, n=1)``: a ``with`` block around a kernel's
  launch; it adds ``n`` to ``kernel.launches_by_variant[variant]`` once
  the block ends without an error, and records a CUDA event pair on the
  current stream around the block;
- ``sync(site)``: a ``with`` block around a host-device synchronization
  (a blocking copy, ``.item()``, ``torch.cuda.synchronize``); it counts
  ``syncs`` and ``sync.<site>`` and records the host's wait as a
  ``tardis.sync`` span;
- ``count(name, n=1)``: a counter;
- ``next_iteration()``: the spans opened after it belong to a new
  iteration (``Simulation.iterate``, the Type IIP workflow's
  ``solve_montecarlo``).

It records while a torch profiler is recording, and between ``start()``
and ``stop()``.  Otherwise a call costs one check of that flag beside the
``record_function`` and the dict update it wraps: no CUDA event, no
synchronization.  Records stay in memory until the next recording session
starts.  A session starts with one ``torch.cuda.synchronize()`` (where
CUDA is in use) and an anchor event; each ``sync`` re-anchors when it
returns, when the stream is known to be empty, so each launch's events
are put on the host's clock from the anchor before them and cannot drift
far.  ``records()`` synchronizes once and returns the session's spans,
launch intervals (on the host's clock) and counters; ``idle_by_span``
splits the card's idle time (the complement of the launch intervals) by
the host spans open during it.  Launch intervals cover the kernels that
``launch`` wraps: torch's own fills, copies and elementwise kernels count
as idle there.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple

import torch
from torch.profiler import record_function

NO_SPAN = "no span"
SYNC_SPAN = "tardis.sync"

_profiler_enabled = torch._C._autograd._profiler_enabled
_now = time.perf_counter_ns


class Span(NamedTuple):
    name: str
    parent: int  # index of the enclosing span in the session, -1 if none
    start_ns: int
    end_ns: int
    iteration: int
    self_ns: int  # the span's time outside its children


class Launch(NamedTuple):
    kernel: str
    variant: str
    start_ns: int
    end_ns: int


class _Recorder:
    """One recording session's state (a fresh session clears it)."""

    def __init__(self):
        self.manual = False  # between start() and stop()
        self.open = False  # a session is recording
        self.session = 0  # bumped at each session's start
        self.cuda = False  # CUDA in use when the session started
        self.iteration = 0
        self.t0 = 0  # host ns at the session's start
        self.spans = []  # [name, parent, start, end, iteration]
        self.stack = []  # indices of the open spans
        self.launches = []  # (kernel, variant, event a, event b, anchor)
        self.anchors = []  # (event, host ns)
        self.counters = {}
        self.by_iteration = {}  # iteration -> its counters
        self.last_anchor_launches = 0
        self.cached = None

    def begin(self):
        self.session += 1
        self.open = True
        self.spans, self.stack, self.launches = [], [], []
        self.anchors, self.counters, self.by_iteration = [], {}, {}
        self.cached = None
        self.cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        if self.cuda:
            torch.cuda.synchronize()
        self.anchor()
        self.t0 = self.anchors[-1][1] if self.anchors else _now()

    def anchor(self):
        """An event on the current stream, taken where the stream is empty,
        beside the host's clock."""
        if not self.cuda:
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.anchors.append((ev, _now()))
        self.last_anchor_launches = len(self.launches)


_R = _Recorder()


def recording() -> bool:
    """Whether the recorder records: a profiler is recording, or between
    ``start()`` and ``stop()``.  Opens a session when recording begins."""
    on = _R.manual or _profiler_enabled()
    if on != _R.open:
        if on:
            _R.begin()
        else:
            _R.open = False
    return on


def start():
    """Record from here to ``stop()`` (a new session)."""
    _R.manual = True
    _R.open = False
    recording()


def stop():
    """End ``start()``'s session; its records stay for ``records()``."""
    _R.manual = False
    recording()


def next_iteration() -> int:
    """The spans opened from here on belong to a new iteration."""
    _R.iteration += 1
    return _R.iteration


class span:
    """``with span("tardis.<stage>"):`` a profiler span that the recorder
    records too; ``@span("tardis.<stage>")`` puts each call of a function
    in one."""

    __slots__ = ("name", "rf", "i", "session")

    def __init__(self, name: str):
        self.name = name

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned

    def __enter__(self):
        self.rf = record_function(self.name)
        self.rf.__enter__()
        if recording():
            st = _R.stack
            self.i = len(_R.spans)
            self.session = _R.session
            _R.spans.append([self.name, st[-1] if st else -1, _now(), None,
                             _R.iteration])
            st.append(self.i)
        else:
            self.i = None
        return self

    def __exit__(self, *exc):
        if self.i is not None and self.session == _R.session:
            _R.spans[self.i][3] = _now()
            _pop(self.i)
        self.rf.__exit__(*exc)
        return False


def _pop(i: int):
    st = _R.stack
    if st and st[-1] == i:
        st.pop()
    elif i in st:
        st.remove(i)


class launch:
    """``with launch(fn, variant, n):`` around the launch of ``n`` kernels
    that ``fn`` counts in its ``launches_by_variant``."""

    __slots__ = ("kernel", "variant", "n", "a", "session")

    def __init__(self, kernel, variant: str, n: int = 1):
        self.kernel, self.variant, self.n = kernel, variant, n

    def __enter__(self):
        self.a = None
        if recording() and _R.cuda and self.n:
            self.session = _R.session
            self.a = torch.cuda.Event(enable_timing=True)
            self.a.record()
        return self

    def __exit__(self, exc_type, *_):
        if exc_type is not None or not self.n:
            return False
        by = self.kernel.launches_by_variant
        by[self.variant] = by.get(self.variant, 0) + self.n
        if self.a is not None and self.session == _R.session:
            b = torch.cuda.Event(enable_timing=True)
            b.record()
            _R.launches.append((self.kernel.__name__, self.variant, self.a,
                                b, len(_R.anchors) - 1))
        return False


class sync:
    """``with sync("<site>"):`` around a host-device synchronization."""

    __slots__ = ("site", "t", "session")

    def __init__(self, site: str):
        self.site = site

    def __enter__(self):
        self.t = None
        if recording():
            self.session = _R.session
            self.t = _now()
        return self

    def __exit__(self, exc_type, *_):
        if self.t is None or self.session != _R.session:
            return False
        st = _R.stack
        _R.spans.append([SYNC_SPAN, st[-1] if st else -1, self.t, _now(),
                         _R.iteration])
        _add("syncs", 1)
        _add("sync." + self.site, 1)
        if len(_R.launches) > _R.last_anchor_launches:
            _R.anchor()
        return False


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` while recording."""
    if recording():
        _add(name, n)


def _add(name: str, n: int):
    c = _R.counters
    c[name] = c.get(name, 0) + n
    c = _R.by_iteration.setdefault(_R.iteration, {})
    c[name] = c.get(name, 0) + n


def records() -> dict:
    """The last session's records: ``window`` (host ns at its start, and
    at the end of its last span or launch), ``spans`` (``Span``, in the
    order they opened), ``launches`` (``Launch``, on the host's clock),
    ``counters`` and ``by_iteration`` (each iteration's counters).
    Synchronizes once, the first time it is asked after a session; spans
    still open end at the window's end."""
    if _R.cached is not None and _R.cached[0] == _R.session:
        return _R.cached[1]
    launches = []
    if _R.launches:
        torch.cuda.synchronize()
        for kernel, variant, a, b, k in _R.launches:
            ev, host = _R.anchors[k]
            launches.append(Launch(
                kernel, variant, host + round(ev.elapsed_time(a) * 1e6),
                host + round(ev.elapsed_time(b) * 1e6)))
    ends = [s[3] for s in _R.spans if s[3] is not None]
    t1 = max([_R.t0] + ends + [x.end_ns for x in launches])
    child = [0] * len(_R.spans)
    for name, parent, s, e, _ in _R.spans:
        if parent >= 0:
            child[parent] += (t1 if e is None else e) - s
    spans = []
    for i, (name, parent, s, e, it) in enumerate(_R.spans):
        e = t1 if e is None else e
        spans.append(Span(name, parent, s, e, it, e - s - child[i]))
    out = dict(window=(_R.t0, t1), spans=spans, launches=launches,
               counters=dict(_R.counters),
               by_iteration={k: dict(v) for k, v in _R.by_iteration.items()})
    _R.cached = (_R.session, out)
    return out


def idle_gaps(recs: dict) -> list:
    """The card's idle intervals in the window: the complement of the
    union of the launch intervals, in host ns."""
    t0, t1 = recs["window"]
    gaps, cur = [], t0
    for s, e in sorted((x.start_ns, x.end_ns) for x in recs["launches"]):
        if s > cur:
            gaps.append((cur, min(s, t1)))
        cur = max(cur, e)
        if cur >= t1:
            break
    if cur < t1:
        gaps.append((cur, t1))
    return [(a, b) for a, b in gaps if b > a]


def idle_by_span(recs: dict, stages=None) -> dict:
    """Seconds of the card's idle time by host span: each idle gap split
    across the innermost spans open during it, in proportion to overlap,
    with ``NO_SPAN`` where none is open.  With ``stages`` (span names),
    each span's share goes to the nearest of them that encloses it (itself
    included), else to ``NO_SPAN``.  The parts add up to the total idle."""
    t0, t1 = recs["window"]
    spans = recs["spans"]
    owner = []
    for i, sp in enumerate(spans):
        j = i
        if stages is not None:
            while j >= 0 and spans[j].name not in stages:
                j = spans[j].parent
        owner.append(spans[j].name if j >= 0 else NO_SPAN)
    # the innermost open span's pieces of the window: ends before starts
    # at one instant, so a span that ends where the next opens hands over
    marks = sorted([(min(max(sp.start_ns, t0), t1), 1, i)
                    for i, sp in enumerate(spans)]
                   + [(min(max(sp.end_ns, t0), t1), 0, i)
                      for i, sp in enumerate(spans)])
    pieces, stack, cur = [], [], t0
    for t, kind, i in marks:
        if t > cur:
            pieces.append((cur, t, owner[stack[-1]] if stack else NO_SPAN))
            cur = t
        if kind:
            stack.append(i)
        elif stack and stack[-1] == i:
            stack.pop()
        elif i in stack:
            stack.remove(i)
    if cur < t1:
        pieces.append((cur, t1, NO_SPAN))
    idle, k = {}, 0
    for a, b in idle_gaps(recs):
        while k < len(pieces) and pieces[k][1] <= a:
            k += 1
        j = k
        while j < len(pieces) and pieces[j][0] < b:
            ps, pe, name = pieces[j]
            overlap = min(b, pe) - max(a, ps)
            if overlap > 0:
                idle[name] = idle.get(name, 0) + overlap
            j += 1
    return {name: ns * 1e-9 for name, ns in idle.items()}
