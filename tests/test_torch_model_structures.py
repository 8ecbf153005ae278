"""``SimulationState.from_config`` on model files, isotope abundances and
velocity windows, and ``run_tardis`` on them, against the JAX package.

Each structure case writes its model file under ``tmp_path`` and builds
the state with both packages from the same configuration; the states are
the same host numpy on the same inputs, so every field is held bitwise
(``assert_states_equal``).  The errors are the JAX package's, type and
message.  Two end-to-end runs follow: a csvy with Ni56 through both
packages' ``run_tardis`` at ``tests/test_torch_slice.py``'s tolerances,
and the model-input options the port's tests did not cover (a velocity
window on a ``specific`` structure, ``simple_ascii`` and ``artis``
abundance files) at 2,048 packets, held per iteration to t_rad within
2.2e-4 and W within 1e-3, the bars these options kept when they were
first compared by hand.
"""

import copy

import numpy as np
import pytest
import torch

from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.config.reader import config_from_dict as torch_config
from tardis_torch.model.state import SimulationState as TorchState
from tardis_torch.simulation.base import run_tardis as torch_run_tardis
from tardis_tpu.atomic.synthetic import make_synthetic_atom_data
from tardis_tpu.config.reader import config_from_dict
from tardis_tpu.model.state import SimulationState
from tardis_tpu.simulation.base import run_tardis

from tests.test_torch_model_io import assert_states_equal
from tests.test_torch_slice import CONFIG

torch.set_num_threads(2)

DAY = 86400.0
N_SHELLS = 12
V_KMS = np.linspace(1.1e4, 2.0e4, N_SHELLS + 1)  # shell edges
# drops shell 0 and the last shell, trims shell 1 and the last-but-one
WINDOW = {"v_inner_boundary": "12100 km/s", "v_outer_boundary": "18900 km/s"}
ELEMENTS = {"O": 8, "Si": 14, "S": 16, "Ca": 20}


def stratified(n):
    """(n,) mass fractions of O, Si, S, Ca and Ni56 / Co56, O outside and
    Ni56 inside."""
    x = np.linspace(0.0, 1.0, n)
    ni = 0.5 * (1.0 - x) ** 2
    co = 0.02 * (1.0 - x)
    rest = 1.0 - ni - co
    return {"O": rest * (0.1 + 0.5 * x), "Si": rest * (0.6 - 0.4 * x),
            "S": rest * (0.2 - 0.1 * x), "Ca": rest * (0.1 + 0.0 * x),
            "Ni56": ni, "Co56": co}


def write_csvy(path):
    n = N_SHELLS + 1
    x = stratified(n)
    cols = ["velocity", "density", *x]
    rows = [",".join(cols)]
    dens = 3e-13 * (V_KMS / 1.1e4) ** -7
    for i in range(n):
        rows.append(",".join(
            repr(float(v)) for v in (V_KMS[i], dens[i], *(x[c][i] for c in x))))
    path.write_text(
        "---\nname: stratified\nmodel_density_time_0: 1 day\n"
        "model_isotope_time_0: 0 day\ndatatype:\n  fields:\n"
        "    - {name: velocity, unit: km/s}\n"
        "    - {name: density, unit: g/cm^3}\n"
        + "".join(f"    - {{name: {c}}}\n" for c in x)
        + "---\n" + "\n".join(rows) + "\n")
    return str(path)


def write_artis(tmp_path):
    """An ARTIS density file (outer edges, log10 density at 2 days) and its
    abundance file (index and Z = 1..30 a shell)."""
    dens = tmp_path / "artis_model.dat"
    lines = [str(N_SHELLS), "2.0"]
    for i, v in enumerate(V_KMS[1:]):
        lines.append(f"{i + 1} {v} {np.log10(2e-11 * (v / 1.1e4) ** -7)}")
    dens.write_text("\n".join(lines) + "\n")
    x = stratified(N_SHELLS)
    table = np.zeros((N_SHELLS, 31))
    table[:, 0] = np.arange(1, N_SHELLS + 1)
    for sym, z in ELEMENTS.items():
        table[:, z] = x[sym]
    table[:, 26] = x["Ni56"] + x["Co56"]
    abund = tmp_path / "artis_abund.dat"
    np.savetxt(abund, table)
    return str(dens), str(abund)


def write_cmfgen(path):
    x = stratified(N_SHELLS + 1)
    lines = ["t0: 1.5 day",
             "Index velocity temperature densities electron_densities "
             + " ".join(x),
             "- km/s K g/cm^3 /cm^3" + " 1" * len(x)]
    for i, v in enumerate(V_KMS):
        lines.append(f"{i} {v} {12000 - 200 * i} {5e-12 * (v / 1.1e4) ** -7} "
                     f"{1e9 / (i + 1)} " + " ".join(repr(float(x[c][i])) for c in x))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def write_blondin(path):
    centres = 0.5 * (V_KMS[:-1] + V_KMS[1:])
    x = stratified(N_SHELLS)
    rows = [f"{i} {v} {4e-13 * (v / 1.1e4) ** -7} {10500 - 150 * i} "
            f"{x['Ni56'][i]} {x['Si'][i] + x['S'][i]} {x['O'][i]} "
            f"{x['Ca'][i] + x['Co56'][i]}"
            for i, v in enumerate(centres)]
    path.write_text("# Blondin toy model\n# tend = 1.0 DAYS\n"
                    "#idx vel[km/s] dens[g/cm^3] temp[K] X_56Ni0 X_Si X_O "
                    "X_Ca\n" + "\n".join(rows) + "\n")
    return str(path)


def base_config():
    return {
        "supernova": {"luminosity_requested": "9.44 log_lsun",
                      "time_explosion": "13 day"},
        "model": {"structure": {"type": "specific",
                                "velocity": {"start": "1.1e4 km/s",
                                             "stop": "2e4 km/s",
                                             "num": N_SHELLS},
                                "density": {"type": "branch85_w7"}},
                  "abundances": {"type": "uniform", "Si": 1.0}},
        "plasma": {},
        "montecarlo": {"seed": 1, "no_of_packets": 100, "iterations": 1},
        "spectrum": {"start": "500 angstrom", "stop": "20000 angstrom",
                     "num": 20},
    }


def file_config(tmp_path, filetype):
    """A configuration whose structure is ``filetype``'s file, written
    under ``tmp_path``."""
    cfg = base_config()
    model = cfg["model"]
    if filetype == "csvy":
        name = write_csvy(tmp_path / "model.csvy")
    elif filetype in ("artis", "simple_ascii"):
        name, abund = write_artis(tmp_path)
        model["abundances"] = {"type": "file", "filename": abund,
                               "filetype": "artis"}
    elif filetype in ("cmfgen", "cmfgen_model"):
        name = write_cmfgen(tmp_path / "cmfgen.csv")
    else:
        name = write_blondin(tmp_path / "toy.dat")
    model["structure"] = {"type": "file", "filetype": filetype,
                          "filename": name}
    return cfg


def both_states(cfg):
    """(port's state, JAX package's state) from one configuration."""
    return (TorchState.from_config(torch_config(copy.deepcopy(cfg))),
            SimulationState.from_config(config_from_dict(copy.deepcopy(cfg))))


FILETYPES = ("csvy", "artis", "simple_ascii", "cmfgen", "cmfgen_model",
             "blondin_toymodel")


@pytest.mark.parametrize("window", [False, True], ids=["whole", "window"])
@pytest.mark.parametrize("filetype", FILETYPES)
def test_file_structure_matches_jax(tmp_path, filetype, window):
    """Every filetype of ``_from_file_structure``, with and without a
    velocity window that drops a shell at each end and trims the next."""
    cfg = file_config(tmp_path, filetype)
    if window:
        cfg["model"]["structure"].update(WINDOW)
    port, ref = both_states(cfg)
    assert_states_equal(port, ref)
    whole, _ = both_states(file_config(tmp_path, filetype))
    assert np.isfinite(port.composition.density).all()
    np.testing.assert_allclose(port.composition.mass_fractions.sum(axis=0),
                               1.0, rtol=1e-12)
    if filetype not in ("artis", "simple_ascii"):
        assert {26, 27, 28} <= set(port.composition.atomic_numbers)
    if window:
        assert port.no_of_shells == whole.no_of_shells - 2
        assert port.geometry.v_inner[0] == 12100e5
        assert port.geometry.v_outer[-1] == 18900e5
        np.testing.assert_array_equal(port.geometry.v_outer[:-1],
                                      whole.geometry.v_outer[1:-2])
        np.testing.assert_array_equal(port.composition.density,
                                      whole.composition.density[1:-1])
        # t_inner is recomputed at the new, larger inner radius
        assert port.t_inner < whole.t_inner
    else:
        assert port.no_of_shells == N_SHELLS


@pytest.mark.parametrize("t0", [0.0, 5 * DAY], ids=["t0_0d", "t0_5d"])
def test_uniform_isotopes_match_jax(t0):
    """Uniform abundances with isotope entries, decayed from
    ``model_isotope_time_0`` to the explosion's 13 days and folded into the
    elements."""
    cfg = base_config()
    cfg["model"]["abundances"] = {
        "type": "uniform", "O": 0.3, "Si": 0.3, "Ni56": 0.2, "Co56": 0.05,
        "Fe52": 0.1, "Cr48": 0.05, "model_isotope_time_0": t0}
    port, ref = both_states(cfg)
    assert_states_equal(port, ref)
    zs = list(port.composition.atomic_numbers)
    assert zs == sorted(zs) and {8, 14, 22, 23, 24, 25, 26, 27, 28} >= set(zs)
    assert {24, 25, 26, 27, 28} <= set(zs)
    np.testing.assert_allclose(port.composition.mass_fractions.sum(axis=0),
                               1.0, rtol=1e-12)
    if t0:
        # a quantity string is read as the same time (the JAX package
        # takes seconds only)
        cfg["model"]["abundances"]["model_isotope_time_0"] = "5 day"
        as_string = TorchState.from_config(torch_config(cfg))
        np.testing.assert_array_equal(as_string.composition.mass_fractions,
                                      port.composition.mass_fractions)


ERRORS = {
    "no_shell_in_window": ({"v_inner_boundary": "30000 km/s"},
                           "no shells inside"),
    "inverted_window": ({"v_inner_boundary": "15000 km/s",
                         "v_outer_boundary": "14000 km/s"},
                        "must be < v_outer_boundary"),
    "unknown_filetype": ({"filetype": "stella"}, "unknown model filetype"),
    "artis_without_file_abundances": (None, "file-type abundances"),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_errors_match_jax(tmp_path, case):
    update, match = ERRORS[case]
    filetype = "artis" if update is None else "cmfgen"
    cfg = file_config(tmp_path, filetype)
    if update is None:
        cfg["model"]["abundances"] = {"type": "uniform", "Si": 1.0}
    else:
        cfg["model"]["structure"].update(update)
    with pytest.raises(ValueError, match=match) as port_err:
        TorchState.from_config(torch_config(copy.deepcopy(cfg)))
    with pytest.raises(ValueError, match=match) as jax_err:
        SimulationState.from_config(config_from_dict(copy.deepcopy(cfg)))
    assert str(port_err.value) == str(jax_err.value)


# ------------------------------------------------------------ end to end


def run_both(cfg, atom):
    """Both packages' run_tardis on one configuration and atomic data."""
    ref = run_tardis(copy.deepcopy(cfg), atom_data=atom)
    port = torch_run_tardis(
        copy.deepcopy(cfg),
        atom_data=atom_data_from_arrays(atom_data_to_arrays(atom)),
        device="cpu")
    return ref, port


def test_csvy_ni56_run_matches_jax(tmp_path):
    """A csvy with a Ni56 column through both packages' run_tardis (Fe / Co
    / Ni in the synthetic data, 10 levels, 4,096 packets, 2 iterations),
    held to ``test_torch_slice.py``'s tolerances: t_inner 1%, t_rad 2%, W
    5%, the final luminosity 2%."""
    cfg = copy.deepcopy(CONFIG)
    cfg["csvy_model"] = write_csvy(tmp_path / "model.csvy")
    del cfg["model"]
    cfg["montecarlo"].update(no_of_packets=4096, last_no_of_packets=4096,
                             iterations=2)
    zs = [8, 14, 16, 20, 26, 27, 28]
    atom = make_synthetic_atom_data(atomic_numbers=tuple(zs),
                                    n_levels=10).prepare(
        selected_atoms=zs, line_interaction_type="macroatom")
    ref, port = run_both(cfg, atom)
    assert list(port.state.composition.atomic_numbers) == zs
    assert len(port.history) == len(ref.history) == 1
    for h_p, h_r in zip(port.history, ref.history):
        assert abs(h_p.t_inner / h_r.t_inner - 1) < 0.01
        np.testing.assert_allclose(h_p.t_radiative, h_r.t_radiative,
                                   rtol=0.02)
        np.testing.assert_allclose(h_p.dilution_factor, h_r.dilution_factor,
                                   rtol=0.05)
    assert np.isfinite(port.spectrum_real.luminosity_nu).all()
    assert abs(port.spectrum_real.luminosity
               / ref.spectrum_real.luminosity - 1) < 0.02


def simple_ascii_file(path, n):
    """A simple_ascii abundance file for the slice's six elements: a centre
    row, then one row a shell with Z = 1..20."""
    zs = {"O": 8, "Mg": 12, "Si": 14, "S": 16, "Ar": 18, "Ca": 20}
    x = np.linspace(0.0, 1.0, n + 1)
    table = np.zeros((n + 1, 21))
    table[:, 0] = np.arange(n + 1)
    fr = {"O": 0.1 + 0.3 * x, "Mg": 0.03 + 0 * x, "Si": 0.55 - 0.3 * x,
          "S": 0.19 + 0 * x, "Ar": 0.04 + 0 * x, "Ca": 0.09 + 0 * x}
    for sym, z in zs.items():
        table[:, z] = fr[sym]
    np.savetxt(path, table)
    return table


def options_config(tmp_path, case):
    cfg = copy.deepcopy(CONFIG)
    structure = cfg["model"]["structure"]
    if case == "window_14":
        structure.update(v_inner_boundary="12500 km/s",
                         v_outer_boundary="18500 km/s")
    elif case == "window_17":
        structure.update(v_inner_boundary="11600 km/s",
                         v_outer_boundary="18900 km/s")
    else:
        path = tmp_path / "abund.dat"
        table = simple_ascii_file(path, 20)
        if case == "artis":
            # one row a shell: the index, then Z = 1..30
            artis = np.zeros((20, 31))
            artis[:, :21] = table[1:]
            np.savetxt(path, artis)
        cfg["model"]["abundances"] = {"type": "file", "filename": str(path),
                                      "filetype": case}
    return cfg


@pytest.mark.parametrize("case", ["window_14", "window_17", "simple_ascii",
                                  "artis"])
def test_model_input_options_match_jax(tmp_path, case, atom_data_prepared):
    """The slice's run with a velocity window on its ``specific`` structure
    (14 and 17 shells) or an abundance file, 2,048 packets: per iteration
    t_rad within 2.2e-4 and W within 1e-3 of the JAX package's."""
    cfg = options_config(tmp_path, case)
    ref, port = run_both(cfg, atom_data_prepared)
    n = {"window_14": 14, "window_17": 17}.get(case, 20)
    assert port.state.no_of_shells == ref.state.no_of_shells == n
    assert len(port.history) == len(ref.history) == 2
    for h_p, h_r in zip(port.history, ref.history):
        np.testing.assert_allclose(h_p.t_radiative, h_r.t_radiative,
                                   rtol=2.2e-4)
        np.testing.assert_allclose(h_p.dilution_factor, h_r.dilution_factor,
                                   rtol=1e-3)
