"""The run rehearsed on the CPU at a tiny size (the program's plain PyTorch
versions stand in for its kernels): the timed path against the reference,
the control, and the faults a run must catch.  The measurement itself
needs a card (``main`` refuses without one)."""

import copy
import dataclasses
import shutil
import subprocess
import sys
import time
from argparse import Namespace

import pytest
import torch

from portbench import harness
from portbench.compare import judge
from portbench.harness import HERE, load_json, load_module
from portbench.trace import Probe

CELL = "w7.converge"
CELLS = ("w7.converge", "iip.model")


def tiny(name=CELL):
    """The cell at a size the CPU runs in seconds: fewer packets and
    iterations; the converge cell on a 12-level recipe, the IIP cell on 5
    shells at 60 days, where its continuum is thin enough that no packet
    random-walks for long."""
    cell = load_json("traffic", name)
    config = copy.deepcopy(load_json("configs", cell["config"]))
    if cell["driver"] == "converge":
        cell = dict(cell, packets=4096, iterations_per_model=3)
        config["atom_recipe"].update(n_levels=12, max_level_jump=None)
    else:
        cell = dict(cell, packets=2048, iterations_per_model=2,
                    ref_packets=256)
        config["tardis"]["supernova"]["time_explosion"] = "60 day"
        config["tardis"]["model"]["structure"]["velocity"]["num"] = 5
    return cell, config


def run(seed=2**31 + 7, seconds=1.0, name=CELL):
    cell, config = tiny(name)
    args = Namespace(workload=name, seed=seed, seconds=seconds, trace=0)
    return harness.run_cell(args, cell, config, torch.device("cpu"),
                            time.time())


@pytest.mark.parametrize("name", CELLS)
def test_rehearsal_matches_reference(name):
    result = run(name=name)
    assert result["correct"], result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "compared"
    # the plain versions and the reference take the same steps
    assert all(v["value"] == 0.0 for v in result["compared"].values())
    e2e = load_json("traffic", name)["end_to_end"]
    assert all(result["metrics"][m]["value"] > 0 for m in e2e)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    cell, config = tiny(name)
    drv = load_module("drivers", cell["driver"])
    d = drv.make(cell, config, torch.device("cpu"), Probe(timing=False))
    d.warm()
    for seed in (11, 12, 13):
        stats = d.window(0.0, seed)
        numbers = d.check(stats["sample"], control=True)
        assert not judge(numbers, cell["limits"], drv.NAMES), numbers


def _transport(monkeypatch, edit):
    import tardis_torch.transport.solver as solver

    original = solver.transport_loop

    def broken(tables, pool_mu, pool_nu, key, **kw):
        return edit(original, tables, pool_mu, pool_nu, key, **kw)

    monkeypatch.setattr(solver, "transport_loop", broken)


def _half(original, tables, mu, nu, key, **kw):
    """Half of the packets left out, the estimators the mean of the rest
    scaled to the whole."""
    n = mu.shape[0]
    if kw.get("pool_w") is not None:
        kw["pool_w"] = kw["pool_w"][:n // 2]
    res = original(tables, mu[:n // 2], nu[:n // 2], key, **kw)

    def padded(x):
        if not x.numel():
            return x
        full = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype)
        full[:n // 2] = x
        return full

    summary = res.summary.clone()
    summary[:2] *= 2
    return dataclasses.replace(
        res, out=padded(res.out), last_interaction=padded(
            res.last_interaction), events=padded(res.events),
        est_j=res.est_j * 2, est_nubar=res.est_nubar * 2, summary=summary,
        cont_moments=res.cont_moments * 2, est_ff_heat=res.est_ff_heat * 2)


def _estimators_altered(original, *args, **kw):
    res = original(*args, **kw)
    return dataclasses.replace(res, est_j=res.est_j * 1.001)


def _packets_altered(original, *args, **kw):
    res = original(*args, **kw)
    out = res.out.clone()
    out[::10, 0] *= 1.0001
    return dataclasses.replace(res, out=out)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("edit", [_half, _estimators_altered,
                                  _packets_altered],
                         ids=["half_batch", "estimators_altered",
                              "packets_altered"])
def test_broken_transport_fails(monkeypatch, edit, name):
    _transport(monkeypatch, edit)
    assert not run(name=name)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_state_left_unchanged_fails(monkeypatch, name):
    from tardis_torch.simulation.base import Simulation

    monkeypatch.setattr(Simulation, "advance_state",
                        lambda self, result, iteration: False)
    assert not run(name=name)["correct"]


def test_forbidden_module_stops_the_run(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert run() is None


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = harness.main(["--workload", CELL, "--seed", "1", "--seconds", "1",
                       "--trace", "0"], time.time())
    assert rc != 0 and capsys.readouterr().out == ""


def test_benchmark_alone_fails(tmp_path):
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        CELL, "--seed", "1", "--seconds", "1", "--trace",
                        "0"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.card
def test_card_rehearsal():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell, config = tiny()
    args = Namespace(workload=CELL, seed=5, seconds=1.0, trace=1)
    result = harness.run_cell(args, cell, config, torch.device("cuda", 0),
                              time.time())
    assert result["device"]["busy_s"] > 0
    assert set(result["metrics"]) == {m.NAME
                                      for m in harness.layers_for(CELL)}
