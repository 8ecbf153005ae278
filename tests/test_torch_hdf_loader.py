"""The port's carsus HDF loader and writer against the JAX package's.

The files are the JAX tests' own (``tests/test_collision_strengths.py``
collision, photoionization / two-photon and molecule files,
``tests/test_advice_fixes.py`` table-format layouts, a
``decay_radiation_data`` table), written again here in ``tmp_path``.  Each
file is read by both loaders and every array must be bit for bit equal,
the pandas tables of ``meta`` equal as frames.  The IIP continuum with
tabulated collision strengths is held against the JAX package's
``ContinuumSolver``, and the decay radiation parsed from a loaded file
against the JAX package's parse.
"""

import copy
import pickle

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

from tardis_torch.atomic import pandas_hdf as torch_pandas_hdf
from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.atomic.hdf_loader import (
    atom_data_from_hdf as torch_loader,
)
from tardis_torch.atomic.hdf_loader import write_atom_data_hdf
from tardis_torch.atomic.synthetic import (
    make_synthetic_atom_data as torch_synthetic,
)
from tardis_torch.config.reader import config_from_dict as torch_config
from tardis_torch.energy_input import decay as torch_decay
from tardis_torch.io.pandas_hdf_writer import write_frame, write_series
from tardis_torch.model.state import SimulationState as TorchState
from tardis_torch.plasma.continuum import ContinuumSolver as TorchContinuum
from tardis_torch.plasma.solver import PlasmaSolver as TorchPlasma
from tardis_tpu.atomic import pandas_hdf as jax_pandas_hdf
from tardis_tpu.atomic.hdf_loader import atom_data_from_hdf as jax_loader
from tardis_tpu.atomic.synthetic import make_synthetic_atom_data
from tardis_tpu.config.reader import config_from_dict
from tardis_tpu.energy_input import decay as jax_decay
from tardis_tpu.io import pandas_hdf_writer as jax_writer
from tardis_tpu.model.state import SimulationState
from tardis_tpu.plasma.continuum import ContinuumSolver
from tardis_tpu.plasma.solver import PlasmaSolver

from tests.test_plasma import BASE_CONFIG

torch.set_num_threads(2)

EV = 1.602176634e-12
U = 1.6605390666e-24
MOLECULES = pd.Index(["H2", "CO"], name="molecule")
TEMPS = [1000.0, 5000.0, 10000.0]
DECAY = pd.DataFrame({
    "Z": [27, 27, 27, 24, 24], "A": [56, 56, 56, 48, 48],
    "Radiation": ["g", "g", "bp", "g", "g"],
    "Rad Energy": [846.77, 1238.29, 610.0, 112.31, 308.24],
    "Rad subtype": [""] * 5,
    "Rad Intensity": [99.9, 66.5, 19.4, 96.0, 100.0]})


def _base_frames(atom):
    """The four tables every carsus file has, as the JAX tests write
    them."""
    return {
        "/atom_data": pd.DataFrame({"atomic_number": atom.atomic_numbers,
                                    "mass": atom.masses / U}),
        "/ionization_data": pd.DataFrame({
            "atomic_number": atom.ionization_z,
            "ion_number": atom.ionization_ion,
            "ionization_energy": atom.ionization_energy / EV}),
        "/levels_data": pd.DataFrame({
            "atomic_number": atom.level_z, "ion_number": atom.level_ion,
            "level_number": atom.level_number,
            "energy": atom.level_energy / EV, "g": atom.level_g,
            "metastable": atom.level_meta}),
        "/lines_data": pd.DataFrame({
            "atomic_number": atom.line_z, "ion_number": atom.line_ion,
            "level_number_lower": atom.level_number[atom.line_lower_idx],
            "level_number_upper": atom.level_number[atom.line_upper_idx],
            "nu": atom.line_nu, "f_lu": atom.line_f_lu}),
    }


def _collision_file(path):
    atom = make_synthetic_atom_data(atomic_numbers=(14,), n_levels=4,
                                    collision_species=((14, 0),))
    co = atom.collision
    frames = _base_frames(atom)
    frames["/collision_data"] = pd.DataFrame({
        "atomic_number": atom.level_z[co.lower_flat],
        "ion_number": atom.level_ion[co.lower_flat],
        "level_number_lower": atom.level_number[co.lower_flat],
        "level_number_upper": atom.level_number[co.upper_flat],
        **{f"t{k}": co.yg[:, k] for k in range(co.yg.shape[1])}})
    with h5py.File(path, "w") as f:
        for key, df in frames.items():
            write_frame(f, key, df)
        write_series(f, "/collision_data_temperatures",
                     pd.Series(co.temperatures))


def _photo_ion_file(path):
    atom = make_synthetic_atom_data(atomic_numbers=(1, 2), max_ion_stage=2,
                                    n_levels=4, continuum_species=((1, 0),))
    pi, tp = atom.photo_ion, atom.two_photon
    block = np.repeat(np.arange(pi.n_continua), np.diff(pi.block_references))
    frames = _base_frames(atom)
    frames["/photoionization_data"] = pd.DataFrame({
        "atomic_number": pi.cont_z[block], "ion_number": pi.cont_ion[block],
        "level_number": pi.cont_level[block], "nu": pi.nu,
        "x_sect": pi.x_sect})
    frames["/two_photon_data"] = pd.DataFrame({
        "atomic_number": tp.z, "ion_number": tp.ion,
        "level_number_lower": tp.level_lower,
        "level_number_upper": tp.level_upper, "A_ul": tp.A_ul,
        "nu0": tp.nu0, "alpha": tp.alpha, "beta": tp.beta,
        "gamma": tp.gamma})
    with h5py.File(path, "w") as f:
        for key, df in frames.items():
            write_frame(f, key, df)


def _molecule_tables():
    return {
        "equilibrium_constants": pd.DataFrame(
            {t: [1.2e3 * (i + 1) * t for i in range(2)] for t in TEMPS},
            index=MOLECULES),
        "partition_functions": pd.DataFrame(
            {t: [2.0 + i + t / 1e4 for i in range(2)] for t in TEMPS},
            index=MOLECULES),
        "dissociation_energies": pd.DataFrame(
            {"dissociation_energy": [4.48, 11.09]}, index=MOLECULES)}


def _molecule_file(path):
    atom = make_synthetic_atom_data(atomic_numbers=(1, 2), max_ion_stage=2,
                                    n_levels=4)
    frames = _base_frames(atom)
    for name, df in _molecule_tables().items():
        frames[f"/molecules/{name}"] = df
    with h5py.File(path, "w") as f:
        for key, df in frames.items():
            write_frame(f, key, df)


def _decay_file(path):
    atom = make_synthetic_atom_data(n_levels=5)
    frames = _base_frames(atom)
    frames["/decay_radiation_data"] = DECAY
    frames["/linelist_atoms"] = frames["/lines_data"][["nu", "f_lu"]]
    with h5py.File(path, "w") as f:
        for key, df in frames.items():
            write_frame(f, key, df)


def _write_table_format(f, key, arrs, index_cols, kinds):
    """A pandas 'table'-format group (PyTables layout: compound dtype and
    pickled object attrs), as ``tests/test_advice_fixes.py`` writes it."""
    grp = f.create_group(key)
    grp.attrs["pandas_type"] = np.bytes_(b"frame_table")
    dt = np.dtype([(n, a.dtype, a.shape[1:]) for n, a in arrs])
    rec = np.zeros(len(arrs[0][1]), dtype=dt)
    for name, a in arrs:
        rec[name] = a
    ds = grp.create_dataset("table", data=rec)
    ds.attrs["index_cols"] = np.void(pickle.dumps(index_cols))
    for name, kind in kinds.items():
        ds.attrs[f"{name}_kind"] = np.void(pickle.dumps(kind))
        ds.attrs[f"{name}_meta"] = np.void(pickle.dumps(None))


def _table_format_file(path):
    """Levels and ionization energies in table format with a (Z, ion)
    MultiIndex, the lines' nu and f_lu as one multi-column block."""
    atom = make_synthetic_atom_data(atomic_numbers=(8, 14), n_levels=6)
    frames = _base_frames(atom)
    lv = frames.pop("/levels_data")
    ion = frames.pop("/ionization_data")
    ln = frames.pop("/lines_data")
    with h5py.File(path, "w") as f:
        for key, df in frames.items():
            write_frame(f, key, df)
        _write_table_format(
            f, "ionization_data",
            [("atomic_number", ion["atomic_number"].to_numpy()),
             ("ion_number", ion["ion_number"].to_numpy()),
             ("values_block_0",
              ion["ionization_energy"].to_numpy().reshape(-1, 1))],
            index_cols=[(0, "atomic_number"), (0, "ion_number")],
            kinds={"values_block_0": ["ionization_energy"]})
        _write_table_format(
            f, "levels_data",
            [("atomic_number", lv["atomic_number"].to_numpy()),
             ("ion_number", lv["ion_number"].to_numpy()),
             ("level_number", lv["level_number"].to_numpy()),
             ("values_block_0", lv[["energy", "g"]].to_numpy()),
             ("values_block_1", lv["metastable"].to_numpy().reshape(-1, 1))],
            index_cols=[(0, "atomic_number"), (0, "ion_number"),
                        (0, "level_number")],
            kinds={"values_block_0": ["energy", "g"],
                   "values_block_1": ["metastable"]})
        _write_table_format(
            f, "lines_data",
            [("index", np.arange(len(ln), dtype=np.int64)),
             ("values_block_0", ln[["atomic_number", "ion_number",
                                    "level_number_lower",
                                    "level_number_upper"]].to_numpy()),
             ("values_block_1", ln[["nu", "f_lu"]].to_numpy())],
            index_cols=[(0, "index")],
            kinds={"values_block_0": ["atomic_number", "ion_number",
                                      "level_number_lower",
                                      "level_number_upper"],
                   "values_block_1": ["nu", "f_lu"]})


def _full_file(path):
    """Every table at once, through the port's own carsus writer."""
    atom = torch_synthetic(atomic_numbers=(1, 2, 8), max_ion_stage=2,
                           n_levels=6, continuum_species=((1, 0),),
                           collision_species=((1, 0), (8, 1)))
    atom.meta["decay_radiation_data"] = DECAY
    atom.meta["molecule_data"] = _molecule_tables()
    write_atom_data_hdf(atom, path)


FILES = {"collision": _collision_file, "photo_ion": _photo_ion_file,
         "molecules": _molecule_file, "decay": _decay_file,
         "table_format": _table_format_file, "full": _full_file}


def _assert_tables_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tables_equal(a[k], b[k])
    else:
        pd.testing.assert_frame_equal(a, b, check_exact=True)


@pytest.mark.parametrize("name", list(FILES))
def test_both_loaders_read_the_same_arrays(tmp_path, name):
    path = str(tmp_path / f"{name}.h5")
    FILES[name](path)
    ref = jax_loader(path)
    port = torch_loader(path)
    a, b = atom_data_to_arrays(port), atom_data_to_arrays(ref)
    assert sorted(a) == sorted(b)
    for k in a:
        if k.startswith("meta/"):
            _assert_tables_equal(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert sorted(port.meta) == sorted(ref.meta)
    assert sorted(port.zeta_data or {}) == sorted(ref.zeta_data or {})
    expect = {"collision": ["collision/yg"], "photo_ion":
              ["photo_ion/x_sect", "two_photon/A_ul"], "molecules":
              ["meta/molecule_data"], "decay": ["meta/decay_radiation_data",
                                                "meta/linelist_atoms"],
              "table_format": ["line_nu"], "full": [
                  "collision/yg", "photo_ion/nu", "two_photon/nu0",
                  "meta/decay_radiation_data", "meta/molecule_data",
                  "zeta_data/8/1/zeta"]}[name]
    for k in expect:
        assert k in a, k
    # the converter carries every table across, collision and meta included
    back = atom_data_to_arrays(atom_data_from_arrays(a))
    assert sorted(back) == sorted(a)


def test_decoders_and_writers_agree(tmp_path):
    """The port's decoder reads the JAX package's writer's file as the JAX
    decoder does, and the two writers write the same frames."""
    df = pd.DataFrame({"x": np.arange(5.0), "k": np.arange(5),
                       "s": list("abcde"), "b": [True, False] * 2 + [True]},
                      index=pd.MultiIndex.from_arrays(
                          [np.arange(5), np.arange(5) % 2], names=["i", "j"]))
    series = pd.Series(np.linspace(0, 1, 4), name="v")
    paths = {}
    for who, module in (("port", None), ("jax", jax_writer)):
        paths[who] = str(tmp_path / f"{who}.h5")
        wf, ws = ((write_frame, write_series) if module is None else
                  (module.write_frame, module.write_series))
        with h5py.File(paths[who], "w") as f:
            wf(f, "/frame", df)
            ws(f, "/series", series)
    for key in ("/frame", "/series"):
        want = jax_pandas_hdf.read_pandas_hdf(paths["jax"], key)
        for path in paths.values():
            got = torch_pandas_hdf.read_pandas_hdf(path, key)
            if key == "/frame":
                pd.testing.assert_frame_equal(got, want, check_exact=True)
            else:
                pd.testing.assert_series_equal(got, want, check_exact=True)
    with torch_pandas_hdf.open_store(paths["port"]) as store:
        assert "/frame" in store and "series" in store


def test_decay_radiation_from_loaded_file(tmp_path):
    path = str(tmp_path / "decay.h5")
    _decay_file(path)
    ref = jax_decay.decay_radiation_from_atom_data(jax_loader(path))
    port = torch_decay.decay_radiation_from_atom_data(torch_loader(path))
    assert sorted(port) == sorted(ref) == ["Co56", "Cr48"]
    for iso in ref:
        np.testing.assert_array_equal(port[iso].gamma_lines,
                                      ref[iso].gamma_lines)
        assert port[iso].positron_intensity == ref[iso].positron_intensity
        assert port[iso].positron_mean_kev == ref[iso].positron_mean_kev


def test_select_atoms_drops_collision_pairs():
    atom = torch_synthetic(n_levels=8, collision_species=((14, 1),))
    assert len(atom.collision) > 0
    assert atom.select_atoms([8, 16]).collision.yg.shape[0] == 0
    kept = atom.select_atoms([14]).collision
    assert len(kept) == len(atom.collision)
    sel = atom.select_atoms([14])
    assert (sel.level_z[kept.lower_flat] == 14).all()
    assert (sel.level_ion[kept.upper_flat] == 1).all()


@pytest.mark.parametrize("with_collision", [False, True])
def test_iip_continuum_with_tabulated_yg(tmp_path, with_collision):
    """The IIP continuum state (collisional coefficients included) of a
    loaded file with and without collision species, against the JAX
    package's ContinuumSolver on the same file (mirrors
    ``tests/test_collision_strengths.py:268``)."""
    path = str(tmp_path / "iip.h5")
    write_atom_data_hdf(torch_synthetic(
        atomic_numbers=(1, 2), max_ion_stage=2, n_levels=10,
        continuum_species=((1, 0),),
        collision_species=((1, 0),) if with_collision else ()), path)
    cfg = copy.deepcopy(BASE_CONFIG)
    cfg["model"]["abundances"] = {"H": 0.8, "He": 0.2}
    state = SimulationState.from_config(config_from_dict(cfg))
    atom = jax_loader(path).prepare(line_interaction_type="macroatom")
    pls = PlasmaSolver(atom, state)
    ref = ContinuumSolver(atom, pls).update(
        pls.update(state.t_radiative, state.dilution_factor))
    tstate = TorchState.from_config(torch_config(cfg))
    tatom = torch_loader(path).prepare(line_interaction_type="macroatom")
    tpl = TorchPlasma(tatom, tstate, "cpu")
    tcs = TorchContinuum(tatom, tpl)
    port = tcs.update(tpl.update(tstate.t_radiative, tstate.dilution_factor))
    for field in vars(ref):
        a = np.asarray(getattr(port, field), np.float64)
        b = np.asarray(getattr(ref, field), np.float64)
        rel = np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300),
                     initial=0.0)
        assert rel <= 1e-10, (field, rel)
    has = tcs._coll_yg_idx >= 0
    assert has.any() == with_collision and (~has).any()


def test_slice_from_a_carsus_file_with_the_walk(tmp_path, monkeypatch):
    """``Simulation.from_config`` with ``atom_data: <carsus file>`` and
    ``sim.transport.use_macro_chain = False`` in both packages (K1's walk
    in each), at ``tests/test_torch_slice.py``'s bars: per-iteration
    t_inner within 1%, t_rad within 2%, W within 5%, the final real
    luminosity within 2%."""
    from tardis_torch.simulation.base import Simulation as TorchSimulation
    from tardis_torch.transport import solver as torch_solver
    from tardis_tpu.simulation.base import Simulation

    from tests.test_torch_slice import CONFIG

    path = str(tmp_path / "atom.h5")
    write_atom_data_hdf(torch_synthetic(), path)
    cfg = copy.deepcopy(CONFIG)
    cfg["atom_data"] = path

    def no_chain(*a, **kw):
        raise AssertionError("the chain tables were built")

    monkeypatch.setattr(torch_solver, "solve_macro_chain", no_chain)
    sims = []
    for sim in (Simulation.from_config(config_from_dict(cfg)),
                TorchSimulation.from_config(torch_config(cfg),
                                            device="cpu")):
        assert sim.atom_data.meta["source"] == path
        sim.transport.use_macro_chain = False
        with torch.no_grad():
            sims.append(sim.run())
    ref, port = sims
    assert len(port.history) == len(ref.history) == 2
    for h_p, h_r in zip(port.history, ref.history):
        assert abs(h_p.t_inner / h_r.t_inner - 1) < 0.01
        np.testing.assert_allclose(h_p.t_radiative, h_r.t_radiative,
                                   rtol=0.02)
        np.testing.assert_allclose(h_p.dilution_factor, h_r.dilution_factor,
                                   rtol=0.05)
    lum_p = port.spectrum_real.luminosity
    assert np.isfinite(port.spectrum_real.luminosity_nu).all()
    assert abs(lum_p / ref.spectrum_real.luminosity - 1) < 0.02
    assert port.last_transport_result.n_immortal == 0
