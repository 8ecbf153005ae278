"""The port's model readers and isotope decay against the JAX package's.

Each test of ``tests/test_model_io.py`` (but the pandas-store decoder,
which ``tests/test_torch_hdf_loader.py`` mirrors) writes its model file
once and reads it with both packages; the two ``SimulationState``s are
compared field by field (edges, density, atomic numbers, mass fractions,
t_inner, t_rad, W).  The readers are the same host numpy on the same
inputs, so the fields are held bitwise.  The JAX test's own checks run on
the port's state too.
"""

import numpy as np
import pytest
import torch

from tardis_torch.config.reader import config_from_dict as torch_config
from tardis_torch.io import model_readers as port_readers
from tardis_torch.io.csvy import simulation_state_from_csvy
from tardis_torch.model import decay as port_decay
from tardis_tpu.config.reader import config_from_dict
from tardis_tpu.io import csvy as jax_csvy
from tardis_tpu.io import model_readers as jax_readers
from tardis_tpu.model import decay as jax_decay

from tests.test_model_io import BASE_CONFIG

torch.set_num_threads(2)


@pytest.fixture
def configs():
    """(JAX package's config, port's config) of ``test_model_io.py``."""
    return config_from_dict(BASE_CONFIG), torch_config(BASE_CONFIG)


def assert_states_equal(port, ref):
    """Every field of the two states bit for bit (and the extra arrays a
    reader keeps, such as CMFGEN's electron densities)."""
    np.testing.assert_array_equal(port.geometry.v_inner, ref.geometry.v_inner)
    np.testing.assert_array_equal(port.geometry.v_outer, ref.geometry.v_outer)
    np.testing.assert_array_equal(port.geometry.r_inner, ref.geometry.r_inner)
    assert port.time_explosion == ref.time_explosion
    np.testing.assert_array_equal(port.composition.density,
                                  ref.composition.density)
    np.testing.assert_array_equal(port.composition.atomic_numbers,
                                  ref.composition.atomic_numbers)
    np.testing.assert_array_equal(port.composition.mass_fractions,
                                  ref.composition.mass_fractions)
    assert port.t_inner == ref.t_inner
    assert port.luminosity_requested == ref.luminosity_requested
    np.testing.assert_array_equal(port.t_radiative, ref.t_radiative)
    np.testing.assert_array_equal(port.dilution_factor, ref.dilution_factor)
    assert port.extra.keys() == ref.extra.keys()
    for key in ref.extra:
        np.testing.assert_array_equal(port.extra[key], ref.extra[key])


# ---------------------------------------------------------------- decay


def test_ni56_bateman_decay():
    """The port's chain solution equals the JAX package's at several
    times and the Bateman solution of the Ni56 -> Co56 -> Fe56 chain."""
    t_half_ni, _ = port_decay._HALF_LIVES["Ni56"]
    t_half_co, _ = port_decay._HALF_LIVES["Co56"]
    lam_ni, lam_co = port_decay.LN2 / t_half_ni, port_decay.LN2 / t_half_co
    t = 2.3 * t_half_ni
    out = port_decay.decay_fractions("Ni56", t)
    np.testing.assert_allclose(out["Ni56"], np.exp(-lam_ni * t), rtol=1e-12)
    co_expected = (lam_ni / (lam_co - lam_ni)
                   * (np.exp(-lam_ni * t) - np.exp(-lam_co * t)))
    np.testing.assert_allclose(out["Co56"], co_expected, rtol=1e-12)
    np.testing.assert_allclose(sum(out.values()), 1.0, rtol=1e-12)
    assert out["Fe56"] > 0
    for iso in ("Ni56", "Co56", "Cr48", "Fe52", "Ti44"):
        for days in (0.0, 1.0, 13.0, 100.0):
            a = port_decay.decay_fractions(iso, days * 86400.0)
            b = jax_decay.decay_fractions(iso, days * 86400.0)
            assert a.keys() == b.keys()
            for k in b:
                assert a[k] == b[k], (iso, days, k)


def test_decay_to_elements_conserves_mass():
    fr = {"Ni56": np.full(5, 0.5), "Cr48": np.full(5, 0.25)}
    out = port_decay.decay_isotopic_mass_fractions(fr, 30 * 86400.0)
    ref = jax_decay.decay_isotopic_mass_fractions(fr, 30 * 86400.0)
    assert out.keys() == ref.keys()
    for z in ref:
        np.testing.assert_array_equal(out[z], ref[z])
    total = sum(v.sum() for v in out.values())
    np.testing.assert_allclose(total, 5 * 0.75, rtol=1e-10)
    assert out[28].max() < 0.05
    assert 27 in out and 26 in out and 22 in out


# ---------------------------------------------------------------- CSVY


def write_iso_csvy(path):
    """The csvy of ``test_csvy_with_isotopes_and_radiation_field``."""
    rows = ["velocity,density,Si,Ni56,t_rad,dilution_factor"]
    for i, vi in enumerate(np.linspace(1.0e4, 2.0e4, 6)):
        rows.append(f"{vi},1e-13,0.6,0.4,{9000 + 100 * i},0.4")
    path.write_text(
        "---\n"
        "name: iso_model\n"
        "model_density_time_0: 1 day\n"
        "model_isotope_time_0: 0 day\n"
        "datatype:\n"
        "  fields:\n"
        "    - {name: velocity, unit: km/s}\n"
        "    - {name: density, unit: g/cm^3}\n"
        "    - {name: Si}\n"
        "    - {name: Ni56}\n"
        "    - {name: t_rad, unit: K}\n"
        "    - {name: dilution_factor}\n"
        "---\n" + "\n".join(rows) + "\n"
    )
    return str(path)


def test_csvy_with_isotopes_and_radiation_field(tmp_path, configs):
    path = write_iso_csvy(tmp_path / "model.csvy")
    state = simulation_state_from_csvy(path, configs[1])
    assert_states_equal(state,
                        jax_csvy.simulation_state_from_csvy(path, configs[0]))
    assert state.no_of_shells == 5
    zs = list(state.composition.atomic_numbers)
    assert 14 in zs and 28 in zs and 27 in zs and 26 in zs
    np.testing.assert_allclose(
        state.composition.mass_fractions.sum(axis=0), 1.0, rtol=1e-10)
    assert 0.05 < state.composition.mass_fractions[zs.index(28), 0] < 0.12
    np.testing.assert_allclose(state.t_radiative,
                               9000 + 100 * np.arange(1, 6))
    np.testing.assert_allclose(state.dilution_factor, 0.4)


# ---------------------------------------------------------------- CMFGEN


def write_cmfgen(path):
    lines = [
        "t0: 0.976 day",
        "Index velocity temperature densities electron_densities Si Ni56",
        "- km/s K g/cm^3 /cm^3 1 1",
    ]
    for i, vi in enumerate(np.linspace(871.0, 1200.0, 6)):
        lines.append(f"{i} {vi} {76000 - 1000 * i} 4.25e-09 2.6e14 0.6 0.4")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_cmfgen_reader(tmp_path, configs):
    path = write_cmfgen(tmp_path / "cmfgen.csv")
    state = port_readers.simulation_state_from_cmfgen(path, configs[1])
    assert_states_equal(
        state, jax_readers.simulation_state_from_cmfgen(path, configs[0]))
    assert state.no_of_shells == 5
    np.testing.assert_allclose(state.geometry.v_inner[0], 871.0e5,
                               rtol=1e-10)
    assert state.composition.density[0] < 4.25e-9
    zs = list(state.composition.atomic_numbers)
    assert 14 in zs and 26 in zs
    np.testing.assert_allclose(state.t_radiative[0], 75000.0)
    assert "electron_densities" in state.extra


# ---------------------------------------------------------------- Blondin


def write_blondin(path, n=8):
    hdr = ("# Blondin toy model\n"
           "# tend = 1.0 DAYS\n"
           "#idx vel[km/s] dens[g/cm^3] temp[K] X_56Ni0 X_Si X_O\n")
    rows = [f"{i} {vi} {1e-13} {9500} 0.5 0.3 0.2"
            for i, vi in enumerate(np.linspace(5e3, 2.2e4, n))]
    path.write_text(hdr + "\n".join(rows) + "\n")
    return str(path)


def test_blondin_reader(tmp_path, configs):
    path = write_blondin(tmp_path / "snia_toy.dat")
    state = port_readers.simulation_state_from_blondin(path, configs[1])
    assert_states_equal(
        state, jax_readers.simulation_state_from_blondin(path, configs[0]))
    assert state.no_of_shells == 8
    zs = list(state.composition.atomic_numbers)
    assert 8 in zs and 14 in zs and 27 in zs
    np.testing.assert_allclose(
        state.composition.mass_fractions.sum(axis=0), 1.0, rtol=1e-10)
    np.testing.assert_allclose(state.t_radiative, 9500.0)


# ---------------------------------------------------------------- SNEC


def test_snec_xg_reader(tmp_path, configs):
    f = tmp_path / "rho.xg"
    blocks = []
    for t in (1e5, 5e5, 1.1e6):
        rows = [f"{1e14 * (i + 1)} {2e8 * (i + 1)} {1e-12 / (i + 1)} "
                f"{8000 - 300 * i}" for i in range(6)]
        blocks.append(f' "Time = {t}\n' + "\n".join(rows))
    f.write_text("\n\n".join(blocks) + "\n")
    times, data = port_readers.read_snec_xg(str(f))
    times_j, data_j = jax_readers.read_snec_xg(str(f))
    np.testing.assert_array_equal(times, times_j)
    assert len(data) == len(data_j) == 3 and data[0].shape == (6, 4)
    for a, b in zip(data, data_j):
        np.testing.assert_array_equal(a, b)
    kw = dict(composition={"H": 0.7, "He": 0.3}, snapshot_time=1.1e6)
    state = port_readers.simulation_state_from_snec(str(f), configs[1], **kw)
    assert_states_equal(state, jax_readers.simulation_state_from_snec(
        str(f), configs[0], **kw))
    assert state.no_of_shells == 5
    assert np.isfinite(state.composition.density).all()
    np.testing.assert_allclose(
        state.composition.mass_fractions.sum(axis=0), 1.0, rtol=1e-10)


# ---------------------------------------------------------------- Arepo


def test_arepo_cone_mapping(configs):
    rng = np.random.default_rng(5)
    N = 40000
    pos = rng.normal(size=(3, N)) * 3e13
    r = np.sqrt((pos**2).sum(axis=0))
    t_snap = 100.0
    vel = pos / t_snap
    rho = 1e-9 * np.exp(-r / 5e13)
    mass = rho * (4e12) ** 3
    ni = np.clip(1.0 - r / 8e13, 0.0, 1.0)
    xnuc = {"Ni56": ni, "Si": 1.0 - ni}
    args = (pos, vel, rho, mass, xnuc)
    state = port_readers.simulation_state_from_arepo(
        *args, snapshot_time=t_snap, config=configs[1], n_shells=10)
    assert_states_equal(state, jax_readers.simulation_state_from_arepo(
        *args, snapshot_time=t_snap, config=configs[0], n_shells=10))
    assert state.no_of_shells == 10
    assert np.all(np.diff(state.geometry.v_inner) > 0)
    np.testing.assert_allclose(
        state.composition.mass_fractions.sum(axis=0), 1.0, rtol=1e-10)
    zs = list(state.composition.atomic_numbers)
    assert 14 in zs and 28 in zs and 26 in zs
    i_fe = zs.index(26)
    assert (state.composition.mass_fractions[i_fe, 0]
            > state.composition.mass_fractions[i_fe, -1])


# ---------------------------------------------------------------- converter


RAW_CMFGEN = (
    "Model output at Time (days)  2.0\n"
    "Number of data points: 4\n"
    "\n"
    "Velocity (km/s)\n"
    "14000.0 13000.0\n"
    "12000.0 11000.0\n"
    "\n"
    "Temperature (10^4K)\n"
    "0.9 0.95 1.0 1.05\n"
    "\n"
    "Density (gm/cm^3)\n"
    "1e-14 2e-14 4e-14 8e-14\n"
    "\n"
    "Electron density (/cm^3)\n"
    "1e8 2e8 4e8 8e8\n"
    "\n"
    "si mass fraction\n"
    "0.6 0.6 0.6 0.6\n"
    "\n"
    "ni 56 mass fraction\n"
    "0.4 0.4 0.4 0.4\n"
    "\n"
)


def test_cmfgen2tardis_converter_roundtrip(tmp_path):
    """Raw CMFGEN output -> TARDIS csv -> SimulationState: both converters
    write the same file, and both readers read the same state from it."""
    from tardis_torch.io.cmfgen2tardis import convert_cmfgen_file
    from tardis_tpu.io.cmfgen2tardis import (
        convert_cmfgen_file as jax_convert,
    )

    raw = tmp_path / "model.fin"
    raw.write_text(RAW_CMFGEN)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    out = convert_cmfgen_file(str(raw), str(tmp_path / "port"))
    out_j = jax_convert(str(raw), str(tmp_path / "jax"))
    assert open(out).read() == open(out_j).read()
    t0, columns, units, data = port_readers.read_cmfgen_model(out)
    np.testing.assert_allclose(t0, 2.0 * 86400.0)
    assert columns[:4] == ["velocity", "temperature", "densities",
                           "electron_densities"]
    assert "Si" in columns and "Ni56" in columns
    np.testing.assert_allclose(data[:, 0], [11000, 12000, 13000, 14000])
    np.testing.assert_allclose(data[:, 1], [10500.0, 10000.0, 9500.0, 9000.0])
    np.testing.assert_allclose(data[:, 4] + data[:, 5], 1.0)

    raw_cfg = {
        "supernova": {"luminosity_requested": "9.44 log_lsun",
                      "time_explosion": "10 day"},
        "model": {"structure": {"type": "file", "filename": out,
                                "filetype": "cmfgen_model"},
                  "abundances": {"type": "file", "filename": out,
                                 "filetype": "cmfgen_model"}},
        "montecarlo": {"seed": 1, "no_of_packets": 100, "iterations": 1},
        "spectrum": {"start": "500 angstrom", "stop": "20000 angstrom",
                     "num": 20},
    }
    state = port_readers.simulation_state_from_cmfgen(
        out, torch_config(raw_cfg))
    assert_states_equal(state, jax_readers.simulation_state_from_cmfgen(
        out, config_from_dict(raw_cfg)))
    assert state.no_of_shells == 3
    idx = list(state.composition.atomic_numbers).index(28)
    assert state.composition.mass_fractions[idx, 0] < 0.4


def test_snec_full_output_reader(tmp_path, configs):
    out = tmp_path / "output"
    out.mkdir()
    times = (1e5, 5e5, 1.1e6)
    n = 6

    def write_xg(name, col):
        blocks = []
        for ti, t in enumerate(times):
            rows = []
            for i in range(n):
                radius = 1e14 * (i + 1) * (1 + 0.1 * ti)
                first = radius if name == "mass" else 1e33 * (i + 1)
                rows.append(f"{first} {col(i, ti)}")
            blocks.append(f' "Time = {t}\n' + "\n".join(rows))
        (out / f"{name}.xg").write_text("\n\n".join(blocks) + "\n")

    write_xg("mass", lambda i, ti: 1e33 * (i + 1))
    write_xg("vel", lambda i, ti: 2e8 * (i + 1))
    write_xg("rho", lambda i, ti: 1e-12 / (i + 1))
    write_xg("temp", lambda i, ti: 8000 - 300 * i)
    comp = {"H_init_frac": [0.6] * n, "He_init_frac": [0.3] * n,
            "O_init_frac": [0.1] * n}
    for name, vals in comp.items():
        (out / f"{name}.dat").write_text(
            "\n".join(f"{i + 1} {v}" for i, v in enumerate(vals)) + "\n")
    (out / "rad_initial.dat").write_text(
        "\n".join(f"{i + 1} {1e14 * (i + 1)}" for i in range(n)) + "\n")
    for name in ("lum_observed", "T_eff"):
        (out / f"{name}.dat").write_text(
            "\n".join(f"{t} {1e42}" for t in times) + "\n")

    snec = port_readers.read_snec_output(str(tmp_path))
    ref = jax_readers.read_snec_output(str(tmp_path))
    np.testing.assert_array_equal(snec.timestamps, ref.timestamps)
    for group in ("profiles", "initial_composition", "initial_quantities",
                  "em_output"):
        a, b = getattr(snec, group), getattr(ref, group)
        assert a.keys() == b.keys(), group
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert snec.profiles["vel"].shape == (3, n)
    assert "tau" not in snec.profiles
    assert "lum_observed" in snec.em_output
    assert len(snec.em_output["time"]) == 3

    state = port_readers.simulation_state_from_snec_output(
        str(tmp_path), configs[1], snapshot_time=1.1e6)
    assert_states_equal(state, jax_readers.simulation_state_from_snec_output(
        str(tmp_path), configs[0], snapshot_time=1.1e6))
    assert state.no_of_shells == n - 1
    assert list(state.composition.atomic_numbers) == [1, 2, 8]
    np.testing.assert_allclose(state.composition.mass_fractions[0], 0.6,
                               rtol=1e-10)
    write_xg("press", lambda i, ti: 1.0)
    bad = (out / "press.xg").read_text().replace("1100000.0", "2200000.0")
    (out / "press.xg").write_text(bad)
    with pytest.raises(ValueError):
        port_readers.read_snec_output(str(tmp_path))


def test_arepo_full_profile_and_csvy_roundtrip(tmp_path, configs):
    rng = np.random.default_rng(11)
    N = 4000
    r = rng.uniform(2e13, 2e14, N)
    theta = np.arccos(rng.uniform(-1, 1, N))
    phi = rng.uniform(0, 2 * np.pi, N)
    pos = np.stack([r * np.sin(theta) * np.cos(phi),
                    r * np.sin(theta) * np.sin(phi), r * np.cos(theta)])
    t_snap = 100.0
    vel = pos / t_snap
    rho = 1e-12 * (r / 2e13) ** -3
    mass = rho * 1e38
    xnuc = {"Si": np.full(N, 0.6), "S": np.full(N, 0.4)}

    data = port_readers.ArepoData(t_snap, pos, vel, rho, mass, xnuc)
    np.testing.assert_allclose(data.volume, mass / rho)
    assert data.species == ["Si", "S"]

    prof = port_readers.arepo_full_profile(pos, vel, rho, mass, xnuc,
                                           inner_radius=3e13)
    prof_j = jax_readers.arepo_full_profile(pos, vel, rho, mass, xnuc,
                                            inner_radius=3e13)
    for a, b in zip(prof[:4], prof_j[:4]):
        np.testing.assert_array_equal(a, b)
    assert len(prof[0]) == int((r >= 3e13).sum()) and prof[0][0] >= 3e13

    v_sh, rho_sh, xn_sh = port_readers.rebin_arepo_profile(*prof,
                                                           n_shells=12)
    edges = np.concatenate([[0.8 * v_sh[0]], v_sh])
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    out = port_readers.arepo_export_csvy(
        str(tmp_path / "port" / "model"), edges, rho_sh, xn_sh,
        time_days=t_snap / 86400.0)
    out_j = jax_readers.arepo_export_csvy(
        str(tmp_path / "jax" / "model"), edges, rho_sh, xn_sh,
        time_days=t_snap / 86400.0)
    assert out.endswith(".csvy")
    assert open(out).read() == open(out_j).read()
    out2 = port_readers.arepo_export_csvy(
        str(tmp_path / "port" / "model"), edges, rho_sh, xn_sh,
        time_days=t_snap / 86400.0)
    assert out2 != out

    state = simulation_state_from_csvy(out, configs[1])
    assert_states_equal(state,
                        jax_csvy.simulation_state_from_csvy(out, configs[0]))
    assert state.no_of_shells == 12
    np.testing.assert_allclose(
        state.composition.mass_fractions.sum(axis=0), 1.0, rtol=1e-6)

    args = (pos, vel, rho, mass, xnuc, t_snap)
    st = port_readers.simulation_state_from_arepo(
        *args, configs[1], n_shells=10, profile="full")
    assert_states_equal(st, jax_readers.simulation_state_from_arepo(
        *args, configs[0], n_shells=10, profile="full"))
    assert st.no_of_shells == 10
    with pytest.raises(ValueError):
        port_readers.simulation_state_from_arepo(*args, configs[1],
                                                 profile="bogus")


def test_snec_isotope_profile_reader(tmp_path):
    f = tmp_path / "profile.iso"
    f.write_text(
        "3 2\n"
        "5.6d1 4.0d0\n"
        "2.8d1 2.0d0\n"
        "1.0d33 1.0d13 8.0d-1 2.0d-1\n"
        "2.0d33 2.0d13 6.0d-1 4.0d-1\n"
        "3.0d33 3.0d13 1.0d-1 9.0d-1\n"
    )
    prof = port_readers.read_snec_isotope_profile(str(f))
    ref = jax_readers.read_snec_isotope_profile(str(f))
    assert prof.isotopes == ref.isotopes == ["Ni56", "He4"]
    for name in ("enclosed_mass", "radius", "mass_fractions"):
        np.testing.assert_array_equal(getattr(prof, name),
                                      getattr(ref, name))
    assert prof.mass_fractions.shape == (3, 2)
    np.testing.assert_allclose(prof.mass_fractions[0], [0.8, 0.2])
    f2 = tmp_path / "bad.iso"
    f2.write_text("2 2\n5.6d1\n2.8d1\n1.0d33 1.0d13 1.0d0\n")
    with pytest.raises(ValueError):
        port_readers.read_snec_isotope_profile(str(f2))
