"""The port's benchmark harnesses against the JAX package's, on the CPU.

``tardis_torch/benchmarks/{transport_bench,production_run,scaling_bench}``
run the JAX modules' workloads through the port's entry points.  Here both
packages build the same problem (the synthetic atomic data at 20 levels,
level jumps up to 10) and draw the same random bits, so:

- ``build_problem``'s geometry, radiation field and densities are equal
  (rtol 1e-12), the line list bit for bit, and the plasma's line tables
  agree within ``PLASMA_RTOL``, the bar ``tests/test_torch_line_tables.py``
  holds K3's plain version to against the JAX host pass;
- ``bench_transport``'s event count is within 5% of the JAX carry's (the
  per-packet agreement is >= 0.95, ``tests/test_torch_transport.py``),
  once the convention is aligned: K1 counts every event of a packet, the
  JAX carry the lanes alive after each step, which leaves out each
  packet's last event;
- the final iteration's spawn records within 1%
  (``tests/test_torch_final.py``), ``production_run``'s t_inner, t_rad and
  W within 1%, 2% and 5% (``tests/test_torch_slice.py``).

Each harness runs on the card unless asked for the CPU, and refuses a
result from another device than the one asked for.
"""

import json
import math
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from tardis_torch.benchmarks import (
    bounds,
    production_run,
    scaling_bench,
    transport_bench,
)
from tardis_tpu.benchmarks import production_run as jax_production_run
from tardis_tpu.benchmarks import transport_bench as jax_transport_bench

torch.set_num_threads(2)

LEVELS, JUMP = 20, 10
MODE = "macroatom"
PLASMA_RTOL = 1e-12  # tests/test_torch_line_tables.py, host f64 pass
N_TRANSPORT = 4096
N_FINAL = 4096
RUN_ARGS = ["--packets", "2048", "--iterations", "2", "--final", "4096",
            "--vpackets", "2", "--levels", str(LEVELS), "--jump", str(JUMP)]


def test_build_problem_matches_jax():
    _, state_j, atom_j, plasma_j = jax_transport_bench.build_problem(
        LEVELS, JUMP, MODE)
    _, state_p, atom_p, plasma_p = transport_bench.build_problem(
        LEVELS, JUMP, MODE, device="cpu")
    for name in ("v_inner", "v_outer", "r_inner", "r_outer"):
        np.testing.assert_allclose(getattr(state_p.geometry, name),
                                   getattr(state_j.geometry, name),
                                   rtol=1e-12, atol=0, err_msg=name)
    assert state_p.time_explosion == state_j.time_explosion
    assert state_p.t_inner == pytest.approx(state_j.t_inner, rel=1e-12)
    for name in ("t_radiative", "dilution_factor"):
        np.testing.assert_allclose(getattr(state_p, name),
                                   getattr(state_j, name), rtol=1e-12,
                                   atol=0, err_msg=name)
    np.testing.assert_allclose(state_p.composition.density,
                               state_j.composition.density, rtol=1e-12,
                               atol=0)
    np.testing.assert_allclose(plasma_p.electron_densities,
                               plasma_j.electron_densities, rtol=1e-12,
                               atol=0)
    np.testing.assert_array_equal(atom_p.line_nu, atom_j.line_nu)
    for name in ("tau_sobolev", "beta_sobolev", "j_blues"):
        np.testing.assert_allclose(getattr(plasma_p, name).numpy(),
                                   getattr(plasma_j, name),
                                   rtol=PLASMA_RTOL, atol=0, err_msg=name)


def test_bench_transport_matches_jax():
    ref = jax_transport_bench.bench_transport(
        n_packets=N_TRANSPORT, batch_size=N_TRANSPORT, n_levels=LEVELS,
        max_level_jump=JUMP, mode=MODE, repeats=1)
    out = transport_bench.bench_transport(
        n_packets=N_TRANSPORT, n_levels=LEVELS, max_level_jump=JUMP,
        mode=MODE, repeats=1, roofline=True, device="cpu")
    for key in ("n_packets", "n_lines", "mode"):
        assert out[key] == ref[key], key
    # the JAX carry leaves out each packet's last event (see above)
    assert out["n_events"] - N_TRANSPORT == pytest.approx(ref["n_events"],
                                                          rel=0.05)
    assert out["stopped"] == 0
    assert out["device"] == "cpu" and out["card"] is None
    assert out["device_ms"] is None  # no CUDA events on the CPU
    roof = out["roofline"]
    assert roof["bound_ms"] > 0
    assert roof["bound_by"] in ("bytes", "operations")
    assert roof["fraction_of_bound"] == pytest.approx(
        roof["bound_ms"] / roof["device_ms"], rel=1e-12)
    assert roof["device_ms"] == pytest.approx(out["time_s"] * 1e3,
                                              rel=1e-12)


def test_bench_e2e_accounting():
    out = transport_bench.bench_e2e(
        n_packets=2048, n_iterations=2, n_levels=LEVELS, max_level_jump=JUMP,
        mode=MODE, device="cpu")
    assert out["e2e_packets_per_s"] == pytest.approx(
        out["n_packets_per_iteration"] * out["n_iterations"]
        / out["e2e_total_s"], rel=1e-12)
    assert len(out["iterate_s"]) == len(out["advance_s"]) == 2
    assert out["best_iteration_s"] == pytest.approx(min(
        a + b for a, b in zip(out["iterate_s"], out["advance_s"])))
    assert out["device"] == "cpu"


def test_bench_final_iteration_records_match_jax():
    kw = dict(n_packets=N_FINAL, n_vpackets=2, n_levels=LEVELS,
              max_level_jump=JUMP, mode=MODE, n_spectrum_bins=1000)
    ref = jax_transport_bench.bench_final_iteration(batch_size=N_FINAL, **kw)
    out = transport_bench.bench_final_iteration(device="cpu", **kw)
    assert out["vp_spawn_records"] == pytest.approx(
        ref["vp_spawn_records"], rel=0.01)
    assert out["n_rays"] == 2 * out["vp_spawn_records"]
    assert out["spectrum_virtual_finite"] and ref["spectrum_virtual_finite"]
    assert out["packets_per_s"] == pytest.approx(N_FINAL / out["time_s"])


def test_bench_iip_smoke():
    out = transport_bench.bench_iip(n_packets=256, max_events=300,
                                    device="cpu")
    assert out["n_packets"] == 256 and out["max_events_cap"] == 300
    assert 256 <= out["n_events"] <= 256 * 300
    assert 0 <= out["stopped"] <= 256
    assert 0.0 < out["lane_efficiency"] <= 1.0
    assert math.isfinite(out["events_per_s"]) and out["events_per_s"] > 0
    assert out["device"] == "cpu" and out["device_ms"] is None


def _jax_production_run(monkeypatch, capsys, args):
    monkeypatch.setattr(sys, "argv", ["production_run", *args])
    jax_production_run.main()
    return json.loads(
        capsys.readouterr().out.strip().splitlines()[-1])


def test_production_run_matches_jax(monkeypatch, capsys):
    ref = _jax_production_run(monkeypatch, capsys, RUN_ARGS)
    out = production_run.main(RUN_ARGS + ["--device", "cpu"])
    assert set(out) == set(ref) - {"platform"} | {"device", "card"}
    for key in ("n_lines", "n_shells", "total_packets", "iterations",
                "resumed_from_iteration"):
        assert out[key] == ref[key], key
    assert out["t_inner"] == pytest.approx(ref["t_inner"], rel=0.01)
    np.testing.assert_allclose(out["t_rad_range"], ref["t_rad_range"],
                               rtol=0.02)
    np.testing.assert_allclose(out["w_range"], ref["w_range"], rtol=0.05)
    assert out["spectra_finite"] and ref["spectra_finite"]
    assert 0.5 < out["emitted_over_requested"] < 2.0
    assert out["device"] == "cpu" and out["card"] is None


def test_production_run_resumes(tmp_path, capsys):
    args = RUN_ARGS + ["--checkpoint", str(tmp_path / "ckpt.h5"),
                       "--device", "cpu"]
    first = production_run.main(args)
    assert first["resumed_from_iteration"] == 0
    capsys.readouterr()
    second = production_run.main(args)
    assert "# resuming from iteration 2" in capsys.readouterr().out
    assert second["resumed_from_iteration"] == 2
    # the whole workload, and this process's part of it: the final
    # iteration only, in one (empty) convergence span
    assert second["total_packets"] == first["total_packets"] == 2 * 2048 \
        + 4096
    assert production_run.packet_accounting(2048, 2, 4096, 2) == (
        2 * 2048 + 4096, 1, 4096)
    assert production_run.packet_accounting(2048, 2, 4096, 0) == (
        2 * 2048 + 4096, 2, 2 * 2048 + 4096)
    assert second["e2e_packets_per_s"] == pytest.approx(
        4096 / (second["convergence_s"] + second["final_iteration_s"]),
        rel=0.05)
    assert second["s_per_iteration"] == pytest.approx(
        second["convergence_s"], abs=0.006)
    assert second["spectra_finite"]


def test_checkpoint_without_h5py_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        production_run.main(RUN_ARGS + ["--checkpoint", "unused.h5",
                                        "--device", "cpu"])


def test_run_scaling_over_two_cpu_shards():
    rows = scaling_bench.run_scaling(per_device=1024,
                                     device_counts=(1, 2, 4),
                                     n_levels=LEVELS, devices=["cpu", "cpu"])
    assert [r["devices"] for r in rows] == [1, 2]  # 4 is past the list
    assert rows[0]["efficiency"] == 1.0
    for r in rows:
        assert r["n_packets"] == 1024 * r["devices"]
        assert r["packets_per_s"] == pytest.approx(r["n_packets"]
                                                   / r["time_s"])
        assert r["est_reduce_s"] >= 0.0


def test_scaling_one_card_line():
    out = scaling_bench.main(["--one-card", "--devices", "1", "2",
                              "--per-device", "256", "--device", "cpu"])
    assert out["shards_of_one_card"] is True and out["skipped"] == []
    assert [r["devices"] for r in out["scaling"]] == [1, 2]
    assert out["device"] == "cpu" and out["card"] is None


def _two_line_tables(S=1, L=2):
    f32 = torch.float32
    return SimpleNamespace(
        r_inner=torch.zeros(S, dtype=f32), r_outer=torch.zeros(S, dtype=f32),
        chi_e=torch.zeros(S, dtype=f32), line_nu=torch.zeros(L, dtype=f32),
        prefix=torch.zeros(S, L + 1, dtype=torch.float64),
        line2macro=torch.zeros(L, dtype=torch.int32),
        chain_cdf=torch.zeros(0, dtype=f32),
        emit_cdf=torch.zeros(0, dtype=f32), n_lines=L, n_shells=S,
        continuum=None, walk=None)


def test_k1_bound_by_hand():
    """Two lines, one shell, 10 packets, 100 events, 3 spawn records.
    Bytes: the pool 8 x 10 = 80, the tables 4 + 4 + 4 + 8 + 24 + 8 = 52,
    the packets' rows 80, the line difference array 8 x 2 x 3 x 1 = 48,
    est_j and est_nubar 16, the summary 32, the records 96: 404 (308
    without the line estimators and records).  Float operations 60 an
    event: 6,000; integer operations 2 x 72 + 8 x ceil(log2 3) = 160 an
    event: 16,000."""
    t = _two_line_tables()
    assert bounds.THREEFRY_OPS == 72
    ms, by = bounds.k1_bound(t, 10, 100, bounds.Rates(hbm_bytes_per_s=1.0),
                             n_records=3)
    assert (ms, by) == (pytest.approx(404e3), "bytes")
    ms, by = bounds.k1_bound(t, 10, 100, bounds.Rates(hbm_bytes_per_s=1.0),
                             line_estimators=False)
    assert (ms, by) == (pytest.approx(260e3), "bytes")
    rates = bounds.Rates()
    ms, by = bounds.k1_bound(t, 10, 100, rates, n_records=3)
    assert by == "operations"
    assert ms == pytest.approx(16_000 / rates.int_ops_per_s * 1e3)
    ms, by = bounds.k1_bound(t, 10, 100, rates._replace(ops_per_s=1e6))
    assert (ms, by) == (pytest.approx(6_000 / 1e6 * 1e3), "operations")


def test_smoke_shares_the_bounds():
    """``chip_smoke.py`` charges K1 through the same module, at the rates
    it reads from the card (an H100 SXM's until then)."""
    assert chip_smoke.k1_bound is bounds.k1_bound
    assert chip_smoke.lane_efficiency is bounds.lane_efficiency
    assert chip_smoke.RATES == bounds.Rates()
    assert bounds.Rates().summary() == dict(
        sms=132, max_sm_clock_mhz=1980.0, int_ops_per_s=132 * 64 * 1.98e9,
        float_ops_per_s=67e12)


HARNESS_MAINS = {
    "transport_bench": (transport_bench.main,
                        ["--packets", "256", "--levels", str(LEVELS),
                         "--jump", str(JUMP)]),
    "production_run": (production_run.main,
                       ["--packets", "256", "--iterations", "1", "--final",
                        "512", "--vpackets", "1", "--levels", str(LEVELS),
                        "--jump", str(JUMP)]),
    "scaling_bench": (scaling_bench.main,
                      ["--one-card", "--devices", "1", "--per-device",
                       "256"]),
}


@pytest.mark.parametrize("name", sorted(HARNESS_MAINS))
def test_harness_needs_a_card_unless_asked(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, args = HARNESS_MAINS[name]
    with pytest.raises(RuntimeError, match="CUDA device"):
        main(args)


@pytest.mark.parametrize("name", sorted(HARNESS_MAINS))
def test_harness_refuses_another_device(monkeypatch, capsys, name):
    """A result that reports another device than the one asked for exits
    non-zero and prints no line."""
    module = sys.modules[f"tardis_torch.benchmarks.{name}"]
    monkeypatch.setattr(module, "device_fields",
                        lambda device: {"device": "cuda", "card": "x"})
    main, args = HARNESS_MAINS[name]
    with pytest.raises(SystemExit, match="refusing"):
        main(args + ["--device", "cpu"])
    assert not any(line.startswith("{")
                   for line in capsys.readouterr().out.splitlines())


def _harness_lines():
    return {
        "transport_bench": {
            "packets_per_s": 1.0, "device_ms": 3.3, "device": "cuda",
            "card": "a card", "e2e": {"e2e_packets_per_s": 2.0},
            "final_iteration": {"time_s": 0.5}, "iip": {"events_per_s": 1.0},
            "roofline": {"fraction_of_bound": 0.2}},
        "production_run": {
            "e2e_packets_per_s": 1.0, "s_per_iteration": 0.2,
            "final_iteration_s": 0.5, "emitted_over_requested": 1.01,
            "spectra_finite": True, "t_rad_range": [9000.0, 11000.0],
            "device": "cuda", "card": "a card"},
        "scaling_bench": {
            "scaling": [{"devices": n, "efficiency": 1.0 / n}
                        for n in (1, 2, 4)],
            "shards_of_one_card": True, "skipped": [], "device": "cuda",
            "card": "a card"},
    }


@pytest.mark.parametrize("name,change,fault", [
    ("transport_bench", None, None),
    ("production_run", None, None),
    ("scaling_bench", None, None),
    ("transport_bench", {"device": "cpu"}, "device 'cpu'"),
    ("transport_bench", {"e2e": {"e2e_packets_per_s": float("nan")}},
     "not finite"),
    ("transport_bench", {"roofline": {}}, "no roofline.fraction_of_bound"),
    ("production_run", {"emitted_over_requested": 1.3},
     "emitted_over_requested 1.3"),
    ("production_run", {"spectra_finite": False}, "spectra not finite"),
    ("production_run", {"t_rad_range": [9000.0, float("inf")]},
     "not finite"),
    ("scaling_bench", {"shards_of_one_card": False}, "one card"),
    ("scaling_bench", {"scaling": [{"devices": 1}, {"devices": 2}]},
     "one card"),
])
def test_smoke_holds_the_harness_lines(name, change, fault):
    """``chip_smoke.py``'s harness phase: the lines of a sound run pass,
    and each fault it must catch stops the run."""
    line = {**_harness_lines()[name], **(change or {})}
    if fault is None:
        chip_smoke.check_harness_line(name, line)
    else:
        with pytest.raises(AssertionError, match=fault):
            chip_smoke.check_harness_line(name, line)
    assert chip_smoke.HARNESS_RUNS["transport_bench"] == [
        "--packets", "2097152", "--levels", "200", "--jump", "60", "--mode",
        "macroatom", "--e2e-iters", "5", "--final-vpackets", "2", "--iip",
        "--roofline"]
