"""The port's HDF output against the JAX package's.

Mirrors ``tests/test_tardis_hdf.py``: the pandas fixed-format series and
frame writers round-trip through both packages' decoders; a finished run
of the same configuration in both packages writes the same key set with
``simulation_to_tardis_hdf`` (the reference's layout) and with
``simulation_to_hdf`` / ``load_simulation_state`` (the checkpoint
format), their arrays of the same shapes and the radiation field within
``tests/test_torch_slice.py``'s tolerances (t_inner 1%, t_rad 2%, W 5%);
and ``run_convergence(checkpoint_path=)`` with ``resume_simulation``
continues an interrupted run on the CPU bit for bit.  h5py is needed for
all of it.
"""

import copy

import numpy as np
import pandas as pd
import pytest
import torch

# the JAX package's writers import h5py at module level
h5py = pytest.importorskip("h5py", reason="the HDF writers need h5py")

from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.atomic.pandas_hdf import (
    H5PandasStore as TorchStore,
    read_pandas_hdf as torch_read,
)
from tardis_torch.config.reader import config_from_dict as torch_config
from tardis_torch.io.hdf import (
    load_simulation_state,
    resume_simulation,
    simulation_to_hdf,
)
from tardis_torch.io.pandas_hdf_writer import (
    simulation_to_tardis_hdf,
    write_frame,
    write_series,
)
from tardis_torch.simulation.base import Simulation as TorchSimulation
from tardis_tpu.atomic.pandas_hdf import H5PandasStore, read_pandas_hdf
from tardis_tpu.config.reader import config_from_dict
from tardis_tpu.io import hdf as jax_hdf
from tardis_tpu.io import pandas_hdf_writer as jax_writer
from tardis_tpu.simulation.base import Simulation

from tests.test_plasma import BASE_CONFIG

torch.set_num_threads(2)


def test_series_frame_roundtrip(tmp_path):
    """The port's writers read back through both packages' decoders."""
    path = str(tmp_path / "rt.h5")
    s = pd.Series([1.5, 2.5, 3.5], name="value")
    mi = pd.MultiIndex.from_arrays(
        [[1, 1, 2], [0, 1, 0]], names=["atomic_number", "ion_number"])
    df = pd.DataFrame(np.arange(6.0).reshape(3, 2), index=mi, columns=[0, 1])
    with h5py.File(path, "w") as f:
        write_series(f, "/t/scalars", s)
        write_frame(f, "/t/ion_number_density", df)
    for read in (torch_read, read_pandas_hdf):
        np.testing.assert_array_equal(read(path, "/t/scalars").to_numpy(),
                                      s.to_numpy())
        df2 = read(path, "/t/ion_number_density")
        np.testing.assert_array_equal(df2.to_numpy(), df.to_numpy())
        assert list(df2.index.names) == ["atomic_number", "ion_number"]


def test_string_index_roundtrip(tmp_path):
    path = str(tmp_path / "s.h5")
    s = pd.Series({"t_inner": 10000.0, "time_explosion": 1.1e6}, name="value")
    with h5py.File(path, "w") as f:
        write_series(f, "/sim/scalars", s)
    for read in (torch_read, read_pandas_hdf):
        s2 = read(path, "/sim/scalars")
        assert s2["t_inner"] == 10000.0
        assert s2["time_explosion"] == 1.1e6


@pytest.fixture(scope="module")
def sims(atom_data_prepared):
    """The JAX test's small run in both packages (same atomic data)."""
    ref = Simulation.from_config(config_from_dict(copy.deepcopy(BASE_CONFIG)),
                                 atom_data=atom_data_prepared)
    ref.run_convergence()
    ref.run_final()
    port = TorchSimulation.from_config(
        torch_config(copy.deepcopy(BASE_CONFIG)),
        atom_data=atom_data_from_arrays(atom_data_to_arrays(
            atom_data_prepared)),
        device="cpu")
    with torch.no_grad():
        port.run_convergence()
        port.run_final()
    return port, ref


# the radiation field's arrays and scalars, held at the slice's tolerances
FIELD_RTOL = {"t_radiative": 0.02, "t_rad": 0.02, "iterations_t_rad": 0.02,
              "dilution_factor": 0.05, "w": 0.05, "iterations_w": 0.05,
              "t_inner": 0.01, "iterations_t_inner": 0.01}


def _leaf(key):
    return key.rstrip("/").rsplit("/", 1)[-1]


def test_simulation_tardis_layout(sims, tmp_path):
    """Both packages write the same keys; every array has the same shape,
    the model's arrays are equal and the radiation field lies within the
    slice's tolerances."""
    port, ref = sims
    path, path_j = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    simulation_to_tardis_hdf(port, path)
    jax_writer.simulation_to_tardis_hdf(ref, path_j)
    store, store_j = TorchStore(path), H5PandasStore(path_j)
    keys = set(store.keys())
    assert keys == set(store_j.keys())
    for expect in (
        "/simulation/simulation_state/scalars",
        "/simulation/simulation_state/t_radiative",
        "/simulation/simulation_state/abundance",
        "/simulation/plasma/tau_sobolevs",
        "/simulation/plasma/level_number_density",
        "/simulation/transport/transport_state/output_nu",
        "/simulation/transport/transport_state/scalars",
        "/simulation/spectrum_solver/spectrum_real_packets/wavelength",
        "/simulation/iterations_t_rad",
        "/simulation/iterations_t_inner",
    ):
        assert expect in keys, expect
    for key in sorted(keys):
        a, b = store[key], store_j[key]
        assert a.shape == b.shape, key
        if key.endswith("scalars"):
            assert list(a.index) == list(b.index), key
        name = _leaf(key)
        if name in FIELD_RTOL:
            np.testing.assert_allclose(a.to_numpy(), b.to_numpy(),
                                       rtol=FIELD_RTOL[name], err_msg=key)
        elif key.startswith("/simulation/simulation_state/") and \
                name != "scalars":
            np.testing.assert_array_equal(a.to_numpy(), b.to_numpy(),
                                          err_msg=key)
    scal = store["/simulation/simulation_state/scalars"]
    assert scal["t_inner"] == port.state.t_inner
    assert store["/simulation/plasma/tau_sobolevs"].shape == (
        port.atom_data.n_lines, port.state.no_of_shells)
    assert (store["/simulation/transport/transport_state/output_nu"]
            .to_numpy() > 0).all()
    assert store["/simulation/iterations_t_rad"].shape[1] == \
        port.state.no_of_shells


def _datasets(path):
    """Every dataset of the file by path, and the state's scalar names."""
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda k, v: out.setdefault(k, v[()]) if isinstance(
            v, h5py.Dataset) else None)
        scalars = set(f["simulation/simulation_state/scalars"].attrs)
    return out, scalars


def test_simulation_to_hdf_and_load(sims, tmp_path):
    """``simulation_to_hdf`` writes the JAX package's datasets and scalars;
    ``load_simulation_state`` and ``resume_simulation`` read them back."""
    port, ref = sims
    path, path_j = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    simulation_to_hdf(port, path)
    jax_hdf.simulation_to_hdf(ref, path_j)
    (data, scalars), (data_j, scalars_j) = _datasets(path), _datasets(path_j)
    assert data.keys() == data_j.keys() and scalars == scalars_j
    for key in data:
        assert data[key].shape == data_j[key].shape, key
        name = _leaf(key)
        if name in FIELD_RTOL:
            np.testing.assert_allclose(data[key], data_j[key],
                                       rtol=FIELD_RTOL[name], err_msg=key)
    ckpt = load_simulation_state(path)
    assert ckpt.keys() == jax_hdf.load_simulation_state(path_j).keys()
    assert ckpt["iterations_executed"] == port.iterations_executed
    np.testing.assert_array_equal(ckpt["t_radiative"], port.state.t_radiative)
    fresh = TorchSimulation.from_config(
        torch_config(copy.deepcopy(BASE_CONFIG)),
        atom_data=port.atom_data, device="cpu")
    resume_simulation(fresh, path)
    np.testing.assert_array_equal(fresh.state.t_radiative,
                                  port.state.t_radiative)
    np.testing.assert_array_equal(fresh.state.dilution_factor,
                                  port.state.dilution_factor)
    assert fresh.state.t_inner == port.state.t_inner
    assert fresh.iterations_executed == port.iterations_executed


def test_auto_checkpoint_resume_bitwise(tmp_path, atom_data_prepared):
    """run_convergence(checkpoint_path=...) + resume_simulation continue an
    interrupted run on the exact trajectory of the uninterrupted one: the
    iteration keys are (seed, iteration) and the checkpoint keeps the n_e
    the last plasma solve started from."""
    cfg = copy.deepcopy(BASE_CONFIG)
    cfg["montecarlo"] = dict(cfg["montecarlo"], no_of_packets=1024,
                             last_no_of_packets=1024, iterations=6, seed=77)
    atom = atom_data_from_arrays(atom_data_to_arrays(atom_data_prepared))
    ckpt = str(tmp_path / "run.ckpt.h5")

    def simulation():
        return TorchSimulation.from_config(torch_config(copy.deepcopy(cfg)),
                                           atom_data=atom, device="cpu")

    with torch.no_grad():
        sim_full = simulation()
        sim_full.run_convergence()

        sim_a = simulation()

        class _Stop(Exception):
            pass

        def crash(s):
            if s.iterations_executed == 3:
                raise _Stop

        sim_a.add_callback(crash)
        with pytest.raises(_Stop):
            sim_a.run_convergence(checkpoint_path=ckpt)
        assert sim_a.iterations_executed == 3

        sim_b = simulation()
        resume_simulation(sim_b, ckpt)
        assert sim_b.iterations_executed == 3
        sim_b.run_convergence(checkpoint_path=ckpt)
    assert sim_b.iterations_executed == sim_full.iterations_executed == 5
    np.testing.assert_array_equal(sim_b.state.t_radiative,
                                  sim_full.state.t_radiative)
    np.testing.assert_array_equal(sim_b.state.dilution_factor,
                                  sim_full.state.dilution_factor)
    assert sim_b.state.t_inner == sim_full.state.t_inner
