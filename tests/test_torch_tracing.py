"""The trace recorder (``tardis_torch/tracing.py``) on the CPU: spans and
their parents, self time and iterations; the split of the card's idle time
by span on synthetic timelines; when it records, and that it makes no CUDA
event when it does not; the clock shared by launches and spans (with a
stand-in for CUDA events); the profiler's view of the spans; and the Type
IIP thermal balance's evaluation counter on the tiny IIP problem."""

import copy
import time

import pytest
import scipy.optimize
import torch

from tardis_torch import tracing
from tardis_torch.atomic.synthetic import make_synthetic_atom_data
from tardis_torch.tracing import NO_SPAN, Launch, Span

torch.set_num_threads(2)


def kernel():
    """A stand-in for a hand-written kernel's launcher."""


kernel.launches_by_variant = {}


@pytest.fixture(autouse=True)
def fresh():
    tracing.stop()
    kernel.launches_by_variant.clear()
    yield
    tracing.stop()


def test_spans_nest_with_parents_self_time_and_iterations():
    tracing.start()
    it = tracing.next_iteration()
    with tracing.span("tardis.outer"):
        with tracing.span("tardis.a"):
            time.sleep(0.002)
        with tracing.span("tardis.b"):
            with tracing.span("tardis.c"):
                time.sleep(0.002)
    tracing.next_iteration()
    with tracing.span("tardis.next"):
        pass
    tracing.stop()
    recs = tracing.records()
    names = [s.name for s in recs["spans"]]
    assert names == ["tardis.outer", "tardis.a", "tardis.b", "tardis.c",
                     "tardis.next"]
    outer, a, b, c, nxt = recs["spans"]
    assert [s.parent for s in recs["spans"]] == [-1, 0, 0, 2, -1]
    assert outer.iteration == a.iteration == b.iteration == c.iteration == it
    assert nxt.iteration == it + 1
    for s in recs["spans"]:
        assert s.start_ns <= s.end_ns
    assert outer.start_ns <= a.start_ns and b.end_ns <= outer.end_ns
    assert a.end_ns <= b.start_ns <= c.start_ns
    dur = {s.name: s.end_ns - s.start_ns for s in recs["spans"]}
    assert outer.self_ns == dur["tardis.outer"] - dur["tardis.a"] \
        - dur["tardis.b"]
    assert b.self_ns == dur["tardis.b"] - dur["tardis.c"]
    assert c.self_ns == dur["tardis.c"] >= 2_000_000
    lo, hi = recs["window"]
    assert lo <= outer.start_ns and nxt.end_ns == hi


def test_decorator_spans_each_call():
    @tracing.span("tardis.decorated")
    def work(x):
        return 2 * x

    tracing.start()
    assert work(3) == 6 and work(4) == 8
    tracing.stop()
    assert [s.name for s in tracing.records()["spans"]] == \
        ["tardis.decorated"] * 2


def timeline(spans, launches, window):
    """Records as ``records()`` gives them, from (name, parent, start, end)
    spans and (start, end) launches in ns."""
    return dict(window=window, launches=[Launch("k", "v", s, e)
                                         for s, e in launches],
                spans=[Span(n, p, s, e, 0, 0) for n, p, s, e in spans],
                counters={}, by_iteration={})


def test_idle_by_span_splits_a_gap_across_three_spans_by_overlap():
    # one idle gap, 100..400, crosses a (50..200), b (200..250) and c
    # (250..450); a second gap 600..1000 lies under nothing
    recs = timeline([("a", -1, 50, 200), ("b", -1, 200, 250),
                     ("c", -1, 250, 450)],
                    [(0, 100), (400, 600)], (0, 1000))
    idle = tracing.idle_by_span(recs)
    ns = {k: round(v * 1e9) for k, v in idle.items()}
    assert ns == {"a": 100, "b": 50, "c": 150, NO_SPAN: 400}
    assert tracing.idle_gaps(recs) == [(100, 400), (600, 1000)]


def test_idle_by_span_charges_the_innermost_span_or_a_stage():
    # outer 0..1000 holds inner 300..500 and sync 500..520 (in inner's
    # parent); launches overlap each other
    recs = timeline([("outer", -1, 0, 1000), ("inner", 0, 300, 500),
                     ("sync", 0, 500, 520)],
                    [(0, 200), (100, 350), (450, 460), (700, 900)],
                    (0, 1000))
    idle = {k: round(v * 1e9) for k, v in tracing.idle_by_span(recs).items()}
    assert idle == {"outer": 180 + 100, "inner": 100 + 40, "sync": 20}
    by_stage = tracing.idle_by_span(recs, ("outer",))
    assert {k: round(v * 1e9) for k, v in by_stage.items()} == {"outer": 440}
    only_inner = tracing.idle_by_span(recs, ("inner",))
    assert {k: round(v * 1e9) for k, v in only_inner.items()} == {
        "inner": 140, NO_SPAN: 300}


@pytest.mark.parametrize("seed", range(4))
def test_idle_by_span_partitions_the_idle(seed):
    g = torch.Generator().manual_seed(seed)

    def ints(n, hi):
        return sorted(torch.randint(0, hi, (n,), generator=g).tolist())

    spans, stack, t = [], [], 0
    for step in ints(60, 10_000):
        if stack and (len(stack) > 3 or step % 2):
            spans[stack.pop()][3] = step
        else:
            spans.append([f"s{len(spans) % 5}", stack[-1] if stack else -1,
                          step, None])
            stack.append(len(spans) - 1)
        t = step
    for i in stack:
        spans[i][3] = t
    bounds = ints(40, 10_000)
    launches = list(zip(bounds[::2], bounds[1::2]))
    recs = timeline([tuple(s) for s in spans], launches, (0, 10_000))
    total = sum(b - a for a, b in tracing.idle_gaps(recs))
    for stages in (None, ("s1", "s3")):
        parts = tracing.idle_by_span(recs, stages)
        assert abs(sum(parts.values()) * 1e9 - total) < 1e-3


def test_records_only_under_a_profiler_and_makes_no_event_when_off(
        monkeypatch):
    def no_event(*_, **__):
        raise AssertionError("a CUDA event while not recording")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    monkeypatch.setattr(torch.cuda, "synchronize", no_event)
    assert not tracing.recording()
    with tracing.span("tardis.off"):
        with tracing.launch(kernel, "default", 3):
            pass
        with tracing.sync("site"):
            pass
        tracing.count("thing")
    assert kernel.launches_by_variant == {"default": 3}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tracing.recording()
        with tracing.span("tardis.on"):
            with tracing.launch(kernel, "default"):
                pass
            with tracing.sync("site"):
                pass
            tracing.count("thing", 2)
    assert not tracing.recording()
    with tracing.span("tardis.after"):
        tracing.count("thing")
    recs = tracing.records()
    assert [s.name for s in recs["spans"]] == ["tardis.on", "tardis.sync"]
    assert recs["launches"] == []  # no CUDA in use: no launch interval
    assert recs["counters"] == {"syncs": 1, "sync.site": 1, "thing": 2}
    assert kernel.launches_by_variant == {"default": 4}


def test_a_failed_launch_is_not_counted():
    with pytest.raises(RuntimeError):
        with tracing.launch(kernel, "default"):
            raise RuntimeError("launch refused")
    with tracing.launch(kernel, "default", 0):
        pass
    assert kernel.launches_by_variant == {}


def test_spans_appear_in_a_cpu_profiler_trace():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("tardis.outer_probe"):
            with tracing.span("tardis.inner_probe"):
                torch.ones(4).sum()
    keys = {e.key for e in prof.key_averages()}
    assert {"tardis.outer_probe", "tardis.inner_probe"} <= keys


class FakeEvent:
    """A CUDA event stand-in on a device clock that runs ``OFFSET`` ns
    ahead of the host's: ``record`` stamps the host's clock."""

    OFFSET = 5_000_000_000

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter_ns() + self.OFFSET

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e-6


def test_launches_share_the_host_clock_through_anchors(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    tracing.start()
    with tracing.span("tardis.stage"):
        t0 = time.perf_counter_ns()
        with tracing.launch(kernel, "default"):
            time.sleep(0.003)
        t1 = time.perf_counter_ns()
        with tracing.sync("site"):
            pass
        with tracing.launch(kernel, "other", 2):
            time.sleep(0.001)
    tracing.stop()
    recs = tracing.records()
    first, second = recs["launches"]
    assert (first.kernel, first.variant) == ("kernel", "default")
    assert second.variant == "other"
    # on the host's clock: within the host's own readings around the launch
    assert t0 - 200_000 <= first.start_ns <= first.end_ns <= t1 + 200_000
    assert first.end_ns - first.start_ns >= 3_000_000
    assert second.start_ns >= first.end_ns
    assert kernel.launches_by_variant == {"default": 1, "other": 2}
    stage = recs["spans"][0]
    lo, hi = recs["window"]
    assert lo <= stage.start_ns and hi >= second.end_ns
    idle = tracing.idle_by_span(recs)
    busy = sum(x.end_ns - x.start_ns for x in recs["launches"])
    assert abs(sum(idle.values()) * 1e9 + busy - (hi - lo)) < 1e-3


IIP_CONFIG = {
    "supernova": {"luminosity_requested": "9.44 log_lsun",
                  "time_explosion": "16 day"},
    "model": {"structure": {"type": "specific",
                            "velocity": {"start": "1.5e4 km/s",
                                         "stop": "2.5e4 km/s", "num": 20},
                            "density": {"type": "branch85_w7"}},
              "abundances": {"type": "uniform", "H": 0.8, "He": 0.2}},
    "plasma": {"line_interaction_type": "macroatom",
               "continuum_interaction": {"species": ["H I"]}},
    "montecarlo": {"seed": 23111963, "no_of_packets": 300, "iterations": 2,
                   "last_no_of_packets": 300},
    "spectrum": {"start": "500 angstrom", "stop": "20000 angstrom",
                 "num": 100},
}


def test_thermal_balance_counts_its_residual_evaluations(monkeypatch):
    from tardis_torch.workflows.type_iip import TypeIIPWorkflow

    evaluations, results = [], []
    least_squares = scipy.optimize.least_squares

    def counted(fun, x0, **kw):
        def f(x):
            evaluations.append(x)
            return fun(x)

        results.append(least_squares(f, x0, **kw))
        return results[-1]

    monkeypatch.setattr(scipy.optimize, "least_squares", counted)
    atom = make_synthetic_atom_data(
        atomic_numbers=(1, 2), max_ion_stage=2, n_levels=10,
        continuum_species=((1, 0),),
    ).prepare(line_interaction_type="macroatom")
    tracing.start()
    TypeIIPWorkflow(copy.deepcopy(IIP_CONFIG), atom_data=atom,
                    thermal_balance_max_nfev=3, device="cpu").run()
    tracing.stop()
    recs = tracing.records()
    assert len(results) == 1  # one convergence iteration, one balance
    c = recs["counters"]
    assert c["thermal_balance.evaluations"] == len(evaluations) > 0
    assert c["thermal_balance.nfev"] == results[0].nfev
    assert c["thermal_balance.njev"] == results[0].njev
    balance = [s for s in recs["spans"] if s.name == "tardis.thermal_balance"]
    assert len(balance) == 1
    by_it = recs["by_iteration"][balance[0].iteration]
    assert by_it["thermal_balance.evaluations"] == len(evaluations)
    names = {s.name for s in recs["spans"]}
    assert {"tardis.from_config", "tardis.readback", "tardis.finalize",
            "tardis.advance", "tardis.plasma"} <= names
    # the closing plasma solve of the balance lies inside its span
    plasma = [s for s in recs["spans"] if s.name == "tardis.plasma"
              and recs["spans"][s.parent].name == "tardis.thermal_balance"]
    assert len(plasma) == 1
