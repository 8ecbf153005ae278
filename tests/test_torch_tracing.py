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


class Cards:
    """Stand-ins for ``torch.cuda`` on a host of ``n`` cards, each with a
    clock of its own (card d runs ``OFFSET * (d + 1)`` ns ahead of the
    host): events know their card, and one card's event cannot be timed
    against another's, as on the hardware."""

    OFFSET = 5_000_000_000

    def __init__(self, monkeypatch, n):
        cards = self
        self.current, self.synced = 0, []
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
        monkeypatch.setattr(torch.cuda, "current_device",
                            lambda: cards.current)
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda d=None: cards.synced.append(
                                cards.current if d is None else d))

        class Event:
            def __init__(self, enable_timing=False):
                self.t = self.card = None

            def record(self):
                self.card = cards.current
                self.t = time.perf_counter_ns() \
                    + cards.OFFSET * (self.card + 1)

            def query(self):
                return True

            def elapsed_time(self, other):
                assert self.card == other.card, "events of two cards"
                return (other.t - self.t) * 1e-6

        class Device:
            def __init__(self, d):
                self.d = d

            def __enter__(self):
                self.prev, cards.current = cards.current, self.d

            def __exit__(self, *exc):
                cards.current = self.prev

        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "device", Device)


def test_each_card_has_its_own_anchors(monkeypatch):
    cards = Cards(monkeypatch, 4)
    tracing.start()
    it = tracing.next_iteration()
    assert cards.synced == [0]  # the session's start: the current card
    h0 = time.perf_counter_ns()
    with tracing.launch(kernel, "default"):
        time.sleep(0.002)
    h1 = time.perf_counter_ns()
    with torch.cuda.device(2):
        with tracing.launch(kernel, "default"):
            time.sleep(0.003)
    h2 = time.perf_counter_ns()
    # card 2's first launch synchronized it and anchored it
    assert cards.synced == [0, 2]
    assert sorted(tracing._R.anchors) == [0, 2]
    with tracing.sync("site"):
        pass
    # the sync re-anchors the current card and card 2, whose last launch
    # has ended (synchronized first)
    assert [len(tracing._R.anchors[d]) for d in (0, 2)] == [2, 2]
    assert cards.synced == [0, 2, 2]
    with torch.cuda.device(2):
        with tracing.launch(kernel, "other"):
            time.sleep(0.001)
    tracing.stop()
    recs = tracing.records()
    assert cards.synced[3:] == [0, 2]  # each card that holds launches
    first, second, third = recs["launches"]
    assert [x.device for x in recs["launches"]] == [0, 2, 2]
    assert {x.iteration for x in recs["launches"]} == {it}
    # each on the host's clock, from its own card's anchors
    assert h0 - 200_000 <= first.start_ns <= first.end_ns <= h1 + 200_000
    assert h1 - 200_000 <= second.start_ns <= second.end_ns <= h2 + 200_000
    assert second.end_ns - second.start_ns >= 3_000_000
    assert third.start_ns >= second.end_ns
    # idle: card 0 by default, another card where asked
    lo, hi = recs["window"]
    idle0 = sum(b - a for a, b in tracing.idle_gaps(recs))
    idle2 = sum(b - a for a, b in tracing.idle_gaps(recs, 2))
    assert idle0 == hi - lo - (first.end_ns - first.start_ns)
    assert idle2 == hi - lo - sum(x.end_ns - x.start_ns
                                  for x in (second, third))
    assert abs(sum(tracing.idle_by_span(recs, device=2).values()) * 1e9
               - idle2) < 1e-3


def test_one_card_session_reads_as_before(monkeypatch):
    """A process that sees one card: every launch on card 0 without asking
    for the current device, one synchronization at the session's start
    and one in ``records()``; its idle split is that of its launches, and
    launches of other cards added to the records leave it unchanged."""
    cards = Cards(monkeypatch, 1)
    monkeypatch.setattr(torch.cuda, "current_device", None)
    tracing.start()
    with tracing.span("tardis.stage"):
        with tracing.launch(kernel, "default"):
            time.sleep(0.002)
        with tracing.sync("site"):
            pass
        with tracing.launch(kernel, "default"):
            pass
    tracing.stop()
    recs = tracing.records()
    assert cards.synced == [0, 0]
    assert [x.device for x in recs["launches"]] == [0, 0]
    assert [len(v) for v in tracing._R.anchors.values()] == [2]
    lo, hi = recs["window"]
    busy = sum(x.end_ns - x.start_ns for x in recs["launches"])
    idle = tracing.idle_by_span(recs)
    assert abs(sum(idle.values()) * 1e9 + busy - (hi - lo)) < 1e-3
    other = dict(recs, launches=recs["launches"] + [
        Launch("k", "v", lo, hi, 1, 0)])
    assert tracing.idle_by_span(other) == idle
    assert tracing.idle_gaps(other) == tracing.idle_gaps(recs)
    assert tracing.idle_gaps(other, 1) == []


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


def _read_back_counters(res):
    from tardis_torch.transport.solver import read_back

    tracing.start()
    it = tracing.next_iteration()
    read_back(res, False, 1, res.est_j.shape[0])
    tracing.stop()
    return tracing.records()["by_iteration"][it]


@pytest.mark.parametrize("continuum", [False, True])
def test_readback_counts_the_tail_in_the_summary_copy(continuum):
    """K1's drain-tail counts come back in the summary's copy: the
    continuum loop's output records ``k1.tail_packets`` and
    ``k1.tail_events`` with no synchronization more than the classic
    loop's (summary, est_j, est_nubar)."""
    from types import SimpleNamespace

    from tardis_torch.transport.kernel import _allocate

    cont = SimpleNamespace(n_grid=3) if continuum else None
    res = _allocate(4, 2, 1, 0, False, 0, "cpu", cont)
    res.summary[:] = torch.tensor([1.0, 2.0, 40.0, 0.0], dtype=torch.float64)
    if continuum:
        res.tail[:] = torch.tensor([3.0, 25.0], dtype=torch.float64)
    c = _read_back_counters(res)
    assert c["syncs"] == c["sync.readback.summary"] + 2 == 3
    if continuum:
        assert c["k1.tail_packets"] == 3 and c["k1.tail_events"] == 25
    else:
        assert "k1.tail_packets" not in c and "k1.tail_events" not in c


@pytest.mark.card
def test_tail_counters_on_the_card():
    """An IIP launch on the card (chip_smoke.py's IIP problem, 4,096
    packets of its first iteration) hands packets to the drain tail:
    ``k1.tail_packets`` >= 1 and ``k1.tail_events`` at most the launch's
    events; its read-back synchronizes as often as the launch without the
    hand-off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    from tardis_torch.transport.kernel import transport_loop
    from tardis_torch.transport.solver import iteration_keys
    from tardis_torch.transport.source import blackbody_source

    device = torch.device("cuda", torch.cuda.current_device())
    state, atom = chip_smoke.build_iip_problem()
    tables = chip_smoke.iip_tables(state, atom, device)
    src_key, run_key = iteration_keys(chip_smoke.SEED, 0)
    mu, nu, w = blackbody_source(src_key, 4096, state.t_inner, device,
                                 "relativistic", chip_smoke.beta_inner(state))
    counters = []
    for threshold in (None, 0):
        res = transport_loop(tables, mu, nu, run_key, max_events=2000,
                             pool_w=w, last_interaction=True,
                             tail_threshold=threshold)
        counters.append((_read_back_counters(res), res.summary[2].item()))
    (on, events), (off, _) = counters
    assert on["k1.tail_packets"] >= 1
    assert 0 < on["k1.tail_events"] <= events
    assert off["k1.tail_packets"] == 0
    syncs = {k: v for k, v in on.items() if k.startswith("sync")}
    assert syncs == {k: v for k, v in off.items() if k.startswith("sync")}
