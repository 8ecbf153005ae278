"""The port's command line, logger, debug packet log and CMFGEN converter.

``tardis_torch.cli.main`` runs a YAML configuration on the CPU with
``--device cpu`` (the default is the card) and writes the chosen
spectrum as ASCII, equal to the run's spectrum; ``--hdf`` writes the
results file, and ``python -m tardis_torch.cli`` does the same in a
process of its own.  ``logging_state`` lets through the same records as
the JAX package's for each level and ``specific_log_level``, with the
config's ``debug`` section and ``montecarlo.logger_buffer`` read as the
JAX package reads them.  ``debug_packet_log`` renders the same events as
the JAX package's on packets whose trajectories agree, and
``cmfgen2tardis.main`` writes the JAX converter's file.
"""

import copy
import dataclasses
import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from tardis_torch import cli
from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.io import logger as port_logger
from tardis_torch.simulation import base as port_base
from tardis_tpu.io import logger as jax_logger

from tests.test_torch_slice import CONFIG

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def restore_loggers():
    """Put both packages' logger trees back as they were: the CLI and
    ``logging_state`` attach handlers and stop propagation, which other
    tests of the same process read through the root logger."""
    saved = {}
    for name in ("tardis_torch", "tardis_tpu"):
        lg = logging.getLogger(name)
        saved[name] = (list(lg.handlers), lg.level, lg.propagate)
    yield
    for name, (handlers, level, propagate) in saved.items():
        lg = logging.getLogger(name)
        lg.handlers[:] = handlers
        lg.setLevel(level)
        lg.propagate = propagate


def tiny_config(tmp_path, **montecarlo):
    """The slice's configuration cut to 512 packets, two iterations and a
    final one of 1,024 with 2 virtual packets, written as YAML."""
    cfg = copy.deepcopy(CONFIG)
    cfg["montecarlo"].update({
        "no_of_packets": 512, "iterations": 2, "last_no_of_packets": 1024,
        "no_of_virtual_packets": 2, **montecarlo})
    cfg["spectrum"]["num"] = 50
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture
def captured(monkeypatch):
    """The simulations the CLI's run_tardis returns."""
    sims = []
    run = port_base.run_tardis

    def recording(*args, **kw):
        sims.append(run(*args, **kw))
        return sims[-1]

    monkeypatch.setattr(port_base, "run_tardis", recording)
    return sims


def spectrum_rows(spec):
    """The rows the CLI writes: wavelength [AA], L_lambda, by wavelength."""
    wl = spec.wavelength * 1e8
    order = np.argsort(wl)
    return np.column_stack([wl[order], spec.luminosity_lambda[order]])


@pytest.mark.parametrize("kind", ["real", "virtual", "integrated"])
def test_cli_writes_the_runs_spectrum(tmp_path, captured, kind):
    out = tmp_path / "spectrum.dat"
    rc = cli.main([tiny_config(tmp_path), str(out), "--spectrum-kind", kind,
                   "--device", "cpu", "--log-level", "WARNING"])
    assert rc == 0 and len(captured) == 1
    sim = captured[0]
    spec = {"real": sim.spectrum_real, "virtual": sim.spectrum_virtual,
            "integrated": sim.spectrum_integrated}[kind]
    written = np.loadtxt(out)
    assert np.isfinite(written).all() and written.shape == (50, 2)
    np.testing.assert_array_equal(written, spectrum_rows(spec))
    assert sim.plasma_solver.device == torch.device("cpu")
    if kind == "real":
        # the same run as a module in a process of its own, with --hdf
        other = tmp_path / "module.dat"
        hdf = tmp_path / "run.h5"
        done = subprocess.run(
            [sys.executable, "-m", "tardis_torch.cli", tiny_config(tmp_path),
             str(other), "--device", "cpu", "--hdf", str(hdf),
             "--log-level", "WARNING"],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert done.returncode == 0, done.stderr[-2000:]
        np.testing.assert_array_equal(np.loadtxt(other), written)
        from tardis_torch.io.hdf import load_simulation_state

        state = load_simulation_state(str(hdf))
        np.testing.assert_array_equal(state["t_radiative"],
                                      sim.state.t_radiative)
        assert state["iterations_executed"] == sim.iterations_executed


def test_cli_hdf(tmp_path, captured):
    """``--hdf`` writes the results file of the run (the JAX package's
    layout, read back by ``load_simulation_state``)."""
    h5py = pytest.importorskip("h5py", reason="--hdf needs h5py")
    from tardis_torch.io.hdf import load_simulation_state

    hdf = tmp_path / "out.h5"
    assert cli.main([tiny_config(tmp_path), "--hdf", str(hdf), "--device",
                     "cpu", "--log-level", "WARNING"]) == 0
    sim = captured[0]
    state = load_simulation_state(str(hdf))
    np.testing.assert_array_equal(state["t_radiative"], sim.state.t_radiative)
    np.testing.assert_array_equal(state["dilution_factor"],
                                  sim.state.dilution_factor)
    assert state["t_inner"] == sim.state.t_inner
    with h5py.File(hdf) as f:
        np.testing.assert_array_equal(
            f["simulation/spectrum/luminosity_nu"][()],
            sim.spectrum_real.luminosity_nu)
        assert "simulation/spectrum_virtual/luminosity_nu" in f


def test_cli_defaults_to_the_card(tmp_path, monkeypatch):
    """Without ``--device`` the CLI asks for the card and raises where
    there is none; an unavailable spectrum kind returns 1."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([tiny_config(tmp_path), str(tmp_path / "s.dat")])
    cfg = tiny_config(tmp_path, no_of_virtual_packets=0)
    assert cli.main([cfg, "--device", "cpu", "--spectrum-kind", "virtual",
                     "--log-level", "WARNING"]) == 1


# ------------------------------------------------------------------ logging


LEVELS = ("DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL")


def records_shown(module, package, capsys, *args, **kw):
    """The levels whose record ``module.logging_state(*args, **kw)`` lets
    through to the console, for a record at each level of a logger under
    ``package``."""
    module.logging_state(*args, **kw)
    capsys.readouterr()
    lg = logging.getLogger(f"{package}.test_torch_cli")
    for level in LEVELS:
        lg.log(getattr(logging, level), "record-at-%s", level)
    handlers = logging.getLogger(package).handlers
    for h in handlers:
        h.flush()
    err = capsys.readouterr().err
    return {level for level in LEVELS if f"record-at-{level}" in err}


def debug_config(**debug):
    cfg = copy.deepcopy(CONFIG)
    cfg["debug"] = debug
    return cfg


LOGGING_CASES = {
    **{f"{level}-specific_{s}": ((level, None), dict(specific_log_level=s))
       for level in ("DEBUG", "INFO", "WARNING", "ERROR") for s in (False,
                                                                   True)},
    # the config's level where the argument gives none, its
    # specific_log_level over the argument's
    "config_level": ((None, debug_config(log_level="ERROR")), {}),
    "argument_over_config_level": (("DEBUG", debug_config(
        log_level="ERROR")), {}),
    "config_specific": (("WARNING", debug_config(
        specific_log_level=True)), dict(specific_log_level=False)),
}


@pytest.mark.parametrize("case", list(LOGGING_CASES))
def test_logging_state_matches_jax(case, capsys):
    (level, raw), kw = LOGGING_CASES[case]
    from tardis_torch.config.reader import config_from_dict as torch_config
    from tardis_tpu.config.reader import config_from_dict

    port_cfg = None if raw is None else torch_config(copy.deepcopy(raw))
    jax_cfg = None if raw is None else config_from_dict(copy.deepcopy(raw))
    shown = records_shown(port_logger, "tardis_torch", capsys, level,
                          port_cfg, **kw)
    ref = records_shown(jax_logger, "tardis_tpu", capsys, level, jax_cfg,
                        **kw)
    assert shown == ref and shown
    if case == "WARNING-specific_True":
        assert shown == {"WARNING"}


def test_logger_buffer_and_errors():
    """``montecarlo.logger_buffer`` puts a MemoryHandler of that capacity
    in front of the console, as in the JAX package; an unknown level
    raises; ``logging_asked`` is false only where nothing asks for
    logging."""
    from tardis_torch.config.reader import config_from_dict as torch_config

    cfg = copy.deepcopy(CONFIG)
    cfg["montecarlo"]["logger_buffer"] = 5
    tl = port_logger.logging_state("INFO", torch_config(cfg))
    ref = jax_logger.logging_state("INFO", cfg)
    assert type(tl._handler) is type(ref._handler) is \
        logging.handlers.MemoryHandler
    assert tl._handler.capacity == ref._handler.capacity == 5
    assert tl.logger.name == "tardis_torch" and not tl.logger.propagate
    with pytest.raises(ValueError):
        port_logger.logging_state("BOGUS", None)
    assert port_logger.logging_asked(None, torch_config(cfg))
    assert port_logger.logging_asked("INFO", None)
    assert not port_logger.logging_asked(None, torch_config(
        copy.deepcopy(CONFIG)))


def test_run_tardis_leaves_the_logger_unless_asked(monkeypatch):
    """run_tardis configures the logger only where it is asked to."""
    calls = []

    def stop(*args, **kw):
        raise RuntimeError("stop")

    monkeypatch.setattr(port_logger, "logging_state",
                        lambda *a: calls.append(a))
    monkeypatch.setattr(port_base.Simulation, "from_config", stop)
    for kw, asked in ((dict(), False), (dict(log_level="DEBUG"), True)):
        with pytest.raises(RuntimeError, match="stop"):
            port_base.run_tardis(copy.deepcopy(CONFIG), device="cpu", **kw)
        assert bool(calls) == asked
        calls.clear()


# ------------------------------------------------------------ debug packets


def test_debug_packet_log_matches_jax(atom_data_prepared):
    """On a run with the r-packet tracker, the packets whose trajectories
    agree (status equal, final nu within 1e-3) render the same events:
    names and shells equal, r / nu / energy within 1e-5."""
    from tardis_torch.io.debug_packets import (
        debug_packet_log,
        packet_events_dataframe,
    )
    from tardis_tpu.io import debug_packets as jax_debug
    from tardis_tpu.simulation.base import run_tardis

    cfg = copy.deepcopy(CONFIG)
    cfg["montecarlo"].update(no_of_packets=512, last_no_of_packets=512,
                             iterations=1)
    cfg["montecarlo"]["tracking"] = {"track_rpacket": True,
                                     "initial_array_length": 16}
    ref = run_tardis(copy.deepcopy(cfg), atom_data=atom_data_prepared)
    port = port_base.run_tardis(
        copy.deepcopy(cfg), device="cpu",
        atom_data=atom_data_from_arrays(atom_data_to_arrays(
            atom_data_prepared)))
    res, res_j = port.last_transport_result, ref.last_transport_result
    agree = (res.output_status == res_j.output_status) & (
        np.abs(res.output_nu - res_j.output_nu) <= 1e-3 * res_j.output_nu)
    assert agree.mean() >= 0.95, agree.mean()
    ids = np.nonzero(agree)[0][:40]
    for pid in ids:
        df = packet_events_dataframe(res, int(pid))
        df_j = jax_debug.packet_events_dataframe(res_j, int(pid))
        assert list(df.columns) == list(df_j.columns)
        assert list(df["event"]) == list(df_j["event"]), pid
        np.testing.assert_array_equal(df["shell"], df_j["shell"])
        for col in ("r", "nu", "energy"):
            np.testing.assert_allclose(df[col], df_j[col], rtol=1e-5,
                                       err_msg=f"{pid} {col}")
    text = debug_packet_log(res, ids[:3])
    text_j = jax_debug.debug_packet_log(res_j, ids[:3])
    lines, lines_j = text.splitlines(), text_j.splitlines()
    assert len(lines) == len(lines_j)
    for a, b in zip(lines, lines_j):
        assert a.split("r=")[0] == b.split("r=")[0]
    assert f"packet {ids[0]}:" in text
    untracked = dataclasses.replace(res, _tracker=None)
    with pytest.raises(ValueError, match="track_rpacket"):
        packet_events_dataframe(untracked, 0)


# ------------------------------------------------------------ cmfgen2tardis


def test_cmfgen2tardis_main_matches_jax(tmp_path, capsys):
    from tardis_torch.io import cmfgen2tardis
    from tardis_tpu.io import cmfgen2tardis as jax_cmfgen2tardis

    from tests.test_torch_model_io import RAW_CMFGEN

    raw = tmp_path / "model.fin"
    raw.write_text(RAW_CMFGEN)
    for name, module in (("port", cmfgen2tardis),
                         ("jax", jax_cmfgen2tardis)):
        (tmp_path / name).mkdir()
        module.main([str(raw), str(tmp_path / name)])
    printed = capsys.readouterr().out.split()
    assert printed == [str(tmp_path / "port" / "model.csv"),
                       str(tmp_path / "jax" / "model.csv")]
    assert (tmp_path / "port" / "model.csv").read_text() == \
        (tmp_path / "jax" / "model.csv").read_text()


# ------------------------------------------------------------- packet bar


def test_packet_bar_advances_once_per_launch(monkeypatch, tmp_path):
    """``show_progress_bars`` gives each iteration a packet bar that
    advances once per K1 launch: once with one device, once a shard with
    two; off by default."""
    from tardis_torch.transport import solver as solver_module

    bars = []

    class Bar:
        def __init__(self, total):
            self.total, self.steps, self.closed = total, [], False
            bars.append(self)

        def update(self, n):
            self.steps.append(n)

        def close(self):
            self.closed = True

    def packet_bar(self, n_packets):
        return Bar(n_packets) if self.show_packet_progress else None

    monkeypatch.setattr(solver_module.TransportSolver, "_packet_bar",
                        packet_bar)
    cfg = yaml.safe_load(open(tiny_config(tmp_path, no_of_virtual_packets=0)))
    port_base.run_tardis(copy.deepcopy(cfg), device="cpu")
    assert not bars
    port_base.run_tardis(copy.deepcopy(cfg), device="cpu",
                         show_progress_bars=True)
    assert [(b.total, b.steps, b.closed) for b in bars] == [
        (512, [512], True), (1024, [1024], True)]
    bars.clear()
    port_base.run_tardis(copy.deepcopy(cfg), device=["cpu", "cpu"],
                         show_progress_bars=True)
    assert [(b.total, b.steps) for b in bars] == [
        (512, [256, 256]), (1024, [512, 512])]
