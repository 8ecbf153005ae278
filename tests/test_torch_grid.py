"""The port's ``TardisGrid`` against the JAX package's.

The cases of ``tests/test_grid.py``: the overrides reach the config and
the simulation state exactly as in the JAX package; ``from_axes`` builds
the Cartesian product, and ``save_grid`` writes the JAX grid's file byte
for byte.  One row runs in both packages on the same atomic data and seed,
so they agree at the port's per-iteration bars (t_rad 2.2e-4, W 1e-3) and
the slice's spectrum bar (2%).  The default device is the card, which a
machine without one refuses.
"""

import copy

import numpy as np
import pandas as pd
import pytest
import torch

from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.grid.base import TardisGrid as TorchGrid
from tardis_tpu.grid.base import TardisGrid

from tests.test_plasma import BASE_CONFIG
from tests.test_torch_slice import CONFIG

torch.set_num_threads(2)

AXES = {
    "supernova.time_explosion": ["10 day", "13 day"],
    "model.structure.velocity.num": [10, 15, 20],
}
T_RAD_RTOL = 2.2e-4
W_RTOL = 1e-3


def _overrides():
    return pd.DataFrame({
        "supernova.time_explosion": ["10 day", "16 day"],
        "montecarlo.seed": [1, 2],
    })


@pytest.mark.parametrize("row", (0, 1))
def test_grid_overrides(row):
    ours = TorchGrid(copy.deepcopy(BASE_CONFIG), _overrides(), device="cpu")
    theirs = TardisGrid(copy.deepcopy(BASE_CONFIG), _overrides())
    c, c_ref = ours.grid_row_to_config(row), theirs.grid_row_to_config(row)
    assert c.supernova.time_explosion == c_ref.supernova.time_explosion
    assert c.montecarlo.seed == c_ref.montecarlo.seed == row + 1
    np.testing.assert_allclose(c.supernova.time_explosion,
                               (10, 16)[row] * 86400.0)
    st = ours.grid_row_to_simulation_state(row)
    st_ref = theirs.grid_row_to_simulation_state(row)
    assert st.time_explosion == st_ref.time_explosion
    for name in ("v_inner", "v_outer", "r_inner", "r_outer"):
        np.testing.assert_array_equal(getattr(st.geometry, name),
                                      getattr(st_ref.geometry, name))
    np.testing.assert_array_equal(st.composition.density,
                                  st_ref.composition.density)
    np.testing.assert_array_equal(st.t_radiative, st_ref.t_radiative)
    assert st.t_inner == st_ref.t_inner
    assert ours.results == [None, None]


def test_grid_from_axes_and_save(tmp_path):
    ours = TorchGrid.from_axes(copy.deepcopy(BASE_CONFIG), AXES,
                               device="cpu")
    theirs = TardisGrid.from_axes(copy.deepcopy(BASE_CONFIG), AXES)
    assert len(ours.grid) == 6
    assert set(ours.grid.columns) == set(AXES)
    assert len(set(map(tuple, ours.grid.values))) == 6
    pd.testing.assert_frame_equal(ours.grid, theirs.grid)
    for row in range(6):
        st = ours.grid_row_to_simulation_state(row)
        assert st.no_of_shells == ours.grid.iloc[row][
            "model.structure.velocity.num"]
    path, ref_path = tmp_path / "grid.csv", tmp_path / "grid_jax.csv"
    ours.save_grid(str(path))
    theirs.save_grid(str(ref_path))
    assert path.read_bytes() == ref_path.read_bytes()
    back = pd.read_csv(path, index_col=0)
    assert list(back.columns) == list(ours.grid.columns)


def test_one_row_in_both_packages(atom_data_prepared):
    cfg = copy.deepcopy(CONFIG)
    cfg["montecarlo"]["iterations"] = 2
    grid = pd.DataFrame({"supernova.time_explosion": ["12 day", "13 day"],
                         "model.structure.velocity.num": [15, 20]})
    ours = TorchGrid(cfg, grid, atom_data=atom_data_from_arrays(
        atom_data_to_arrays(atom_data_prepared)), device="cpu")
    theirs = TardisGrid(copy.deepcopy(cfg), grid,
                        atom_data=atom_data_prepared)
    sim, ref = ours.run_sim_from_grid(0), theirs.run_sim_from_grid(0)
    assert ours.results[0] is sim and ours.results[1] is None
    assert sim.state.no_of_shells == ref.state.no_of_shells == 15
    assert sim.state.time_explosion == ref.state.time_explosion
    assert sim.plasma_solver.device == torch.device("cpu")
    for h, h_ref in zip(sim.history, ref.history, strict=True):
        np.testing.assert_allclose(h.t_radiative, h_ref.t_radiative,
                                   rtol=T_RAD_RTOL)
        np.testing.assert_allclose(h.dilution_factor, h_ref.dilution_factor,
                                   rtol=W_RTOL)
        assert abs(h.t_inner / h_ref.t_inner - 1) < T_RAD_RTOL
    assert abs(sim.spectrum_real.luminosity
               / ref.spectrum_real.luminosity - 1) < 0.02
    assert np.isfinite(sim.spectrum_real.luminosity_nu).all()


def test_run_fills_every_row(atom_data_prepared):
    cfg = copy.deepcopy(CONFIG)
    cfg["montecarlo"].update(iterations=1, last_no_of_packets=1024)
    grid = TorchGrid.from_axes(cfg, {"model.structure.velocity.num": [8, 12]},
                               atom_data=atom_data_from_arrays(
                                   atom_data_to_arrays(atom_data_prepared)),
                               device="cpu")
    results = grid.run()
    assert [s.state.no_of_shells for s in results] == [8, 12]
    for sim in results:
        assert np.isfinite(sim.spectrum_real.luminosity_nu).all()


def test_default_device_is_the_card(monkeypatch):
    """Without a device the grid's simulations ask for the card, and a
    machine without one raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    grid = TorchGrid(copy.deepcopy(CONFIG), _overrides())
    assert grid.device is None
    with pytest.raises(RuntimeError, match="CUDA"):
        grid.run_sim_from_grid(0)
