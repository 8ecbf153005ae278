"""External ejecta-model file readers.

Counterparts of the reference's reader zoo (tardis/io/model/
readers/: artis, stella, cmfgen): parse the foreign columnar formats into
(velocity_edges, density, abundances) ready for SimulationState assembly.
The port's copy of ``tardis_tpu/io/model_readers.py``: host numpy, the
same arithmetic in the same order, so both packages build the same state
from the same file.
"""

from __future__ import annotations

import re

import numpy as np
from dataclasses import dataclass

from tardis_torch.atomic.atom_data import ATOMIC_SYMBOLS, SYMBOL_TO_Z
from tardis_torch.model.density import density_after_time
from tardis_torch.model.geometry import Radial1DGeometry
from tardis_torch.model.state import Composition, SimulationState


def read_artis_density(path: str):
    """ARTIS model.txt: line1 = #shells, line2 = time [days], then rows
    (index, v_outer [km/s], log10(rho), ...)
    (reference io/model/readers/artis.py)."""
    with open(path) as fh:
        lines = [ln.strip() for ln in fh if ln.strip()]
    n_shells = int(lines[0])
    time_days = float(lines[1])
    rows = [list(map(float, ln.split())) for ln in lines[2 : 2 + n_shells]]
    rows = np.asarray(rows)
    v_outer = rows[:, 1] * 1e5  # cm/s
    density = 10.0 ** rows[:, 2]
    return time_days * 86400.0, v_outer, density


def read_stella_model(path: str):
    """STELLA .stl-like output: header rows then whitespace table with
    columns including 'mass of cell', 'cell center R', 'cell center v',
    'avg density' and element mass fractions
    (reference io/model/readers/stella.py)."""
    with open(path) as fh:
        content = fh.read()
    m = re.search(r"days post max Lbol\s+([-\d.eE+]+)", content)
    time_days = float(m.group(1)) if m else 0.0
    lines = content.splitlines()
    header_idx = None
    for i, ln in enumerate(lines):
        if "mass of cell" in ln or ("zone" in ln.lower() and "rho" in ln):
            header_idx = i
            break
    if header_idx is None:
        raise ValueError("could not locate STELLA table header")
    cols = re.split(r"\s{2,}", lines[header_idx].strip())
    data = []
    for ln in lines[header_idx + 1 :]:
        parts = ln.split()
        if not parts:
            continue
        try:
            data.append([float(x) for x in parts])
        except ValueError:
            break
    data = np.asarray(data)
    return time_days * 86400.0, cols, data


def simulation_state_from_artis(
    density_path: str,
    abundance_path: str,
    config,
) -> SimulationState:
    """ARTIS density + abundance files -> SimulationState.

    The abundance file has one row per shell with mass fractions for
    Z = 1..30 (reference readers/artis.py).
    """
    time_0, v_outer, density_0 = read_artis_density(density_path)
    abund = np.loadtxt(abundance_path)
    if abund.ndim == 1:
        abund = abund[None, :]
    # first column may be a shell index
    if abund.shape[1] in (31,):
        abund = abund[:, 1:]
    t_exp = config.supernova.time_explosion
    v_inner0 = v_outer[0] * 0.95  # ARTIS tabulates outer edges only
    edges = np.concatenate([[v_inner0], v_outer])
    geometry = Radial1DGeometry.from_velocity_grid(edges, t_exp)
    density = density_after_time(density_0, time_0, t_exp)

    zs = []
    fracs = []
    for z in range(1, min(31, abund.shape[1] + 1)):
        col = abund[:, z - 1]
        if np.any(col > 0):
            zs.append(z)
            fracs.append(col)
    mass_fractions = np.stack(fracs)
    norm = mass_fractions.sum(axis=0)
    mass_fractions /= np.where(norm > 0, norm, 1.0)

    from tardis_torch.constants import B_WIEN, C, SIGMA_SB

    L = config.supernova.luminosity_requested
    r0 = geometry.r_inner[0]
    t_inner = float((L / (4.0 * np.pi * r0**2 * SIGMA_SB)) ** 0.25)
    t_radiative = B_WIEN / (
        (B_WIEN / t_inner)
        * (1.0 + (geometry.v_middle - geometry.v_inner[0]) / C)
    )
    return SimulationState(
        geometry=geometry,
        composition=Composition(
            atomic_numbers=np.asarray(zs),
            mass_fractions=mass_fractions,
            density=density,
        ),
        time_explosion=t_exp,
        luminosity_requested=L,
        t_inner=t_inner,
        t_radiative=t_radiative,
        dilution_factor=geometry.geometric_dilution_factor(),
    )


# ---------------------------------------------------------------------------
# shared state assembly


def _assemble_state(geometry, elements, mass_fractions, density, config,
                    t_radiative=None):
    """(elements, fractions, density) + config -> SimulationState."""
    from tardis_torch.constants import B_WIEN, C, SIGMA_SB

    mass_fractions = np.asarray(mass_fractions, dtype=np.float64)
    norm = mass_fractions.sum(axis=0)
    mass_fractions = mass_fractions / np.where(norm > 0, norm, 1.0)
    L = config.supernova.luminosity_requested
    r0 = geometry.r_inner[0]
    t_inner = float((L / (4.0 * np.pi * r0**2 * SIGMA_SB)) ** 0.25)
    if t_radiative is None:
        t_radiative = B_WIEN / (
            (B_WIEN / t_inner)
            * (1.0 + (geometry.v_middle - geometry.v_inner[0]) / C)
        )
    return SimulationState(
        geometry=geometry,
        composition=Composition(
            atomic_numbers=np.asarray(elements),
            mass_fractions=mass_fractions,
            density=np.asarray(density, dtype=np.float64),
        ),
        time_explosion=geometry.time_explosion,
        luminosity_requested=L,
        t_inner=t_inner,
        t_radiative=np.asarray(t_radiative, dtype=np.float64),
        dilution_factor=geometry.geometric_dilution_factor(),
    )


def _split_element_isotope_columns(names):
    """Column names -> (element columns {name: Z}, isotope columns [name])."""
    from tardis_torch.model.decay import parse_isotope

    elem, iso = {}, []
    for name in names:
        z = SYMBOL_TO_Z.get(name)
        if z is not None:
            elem[name] = z
        elif parse_isotope(name) is not None:
            iso.append(name)
    return elem, iso


# ---------------------------------------------------------------------------
# CMFGEN


def read_cmfgen_model(path: str):
    """CMFGEN export: 't0: X day' header, then an Index-led whitespace table
    with a units row (reference io/model/readers/cmfgen.py:23-75).

    Returns (t0_seconds, columns, units, data (rows, cols))."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    m = re.match(r"t0:\s+([\d.eE+-]+)\s+day", lines[0].strip())
    if m is None:
        raise ValueError("CMFGEN model must start with 't0: <value> day'")
    t0 = float(m.group(1)) * 86400.0
    if "Index" not in lines[1]:
        raise ValueError(
            '"Index" is required in the CMFGEN input file to infer columns'
        )
    columns = lines[1].split()[1:]
    units = lines[2].split()[1:]
    data = np.array(
        [[float(x) for x in ln.split()[1:]] for ln in lines[3:] if ln.strip()]
    )
    return t0, columns, units, data


def simulation_state_from_cmfgen(path: str, config) -> SimulationState:
    """CMFGEN model file -> SimulationState.

    Columns: velocity [km/s], temperature [K], densities [g/cm^3],
    electron_densities, then element/isotope mass fractions; isotopes are
    decayed from t0 to time_explosion.
    """
    from tardis_torch.model.decay import fold_isotopes_into_elements

    t0, columns, units, data = read_cmfgen_model(path)
    col = {name: data[:, i] for i, name in enumerate(columns)}
    t_exp = config.supernova.time_explosion

    velocity = col["velocity"] * 1e5  # km/s -> cm/s (unit row fixed format)
    geometry = Radial1DGeometry.from_velocity_grid(velocity, t_exp)
    density_0 = col["densities"][1:]
    density = density_after_time(density_0, t0, t_exp)

    elem_cols, iso_cols = _split_element_isotope_columns(columns)
    elements = list(elem_cols.values())
    fractions = [col[name][1:] for name in elem_cols]
    if iso_cols:
        elements, mass_fractions = fold_isotopes_into_elements(
            elements, fractions,
            {name: col[name][1:] for name in iso_cols},
            max(t_exp - t0, 0.0),
        )
    else:
        order = np.argsort(elements)
        elements = np.asarray(elements)[order]
        mass_fractions = np.stack([fractions[i] for i in order])

    t_rad = col["temperature"][1:] if "temperature" in col else None
    state = _assemble_state(
        geometry, elements, mass_fractions, density, config,
        t_radiative=t_rad,
    )
    if "electron_densities" in col:
        state.extra["electron_densities"] = col["electron_densities"][1:]
    return state


# ---------------------------------------------------------------------------
# Blondin toy model


def read_blondin_toymodel(path: str):
    """Blondin toy-model format: 'tend = X DAYS' header + '#idx'-led table
    (reference io/model/readers/blondin_toymodel.py:14-123).

    Returns (t0_seconds, columns, data)."""
    with open(path) as fh:
        content = fh.read()
    m = re.search(r"tend\s*=\s*([\d.eE+-]+)", content)
    if m is None:
        raise ValueError("Blondin toymodel must contain 'tend = <days>'")
    t0 = float(m.group(1)) * 86400.0
    header_line = None
    for ln in content.splitlines():
        if ln.startswith("#idx"):
            header_line = ln
            break
    if header_line is None:
        raise ValueError("Blondin toymodel must contain a '#idx' header")
    columns = [re.sub(r"\[.+?\]", "", tok) for tok in header_line[1:].split()]
    rows = []
    for ln in content.splitlines():
        if ln.startswith("#") or not ln.strip():
            continue
        try:
            rows.append([float(x) for x in ln.split()])
        except ValueError:
            continue
    data = np.asarray(rows)
    return t0, columns, data


def simulation_state_from_blondin(path: str, config) -> SimulationState:
    """Blondin toymodel -> SimulationState (vel/dens/temp + X_* fractions;
    cell-centre velocities are converted to outer edges as the reference
    does, blondin_toymodel.py:84-92)."""
    from tardis_torch.model.decay import fold_isotopes_into_elements

    t0, columns, data = read_blondin_toymodel(path)
    col = {name: data[:, i] for i, name in enumerate(columns)}
    t_exp = config.supernova.time_explosion

    v_center = col["vel"] * 1e5 if col["vel"].max() < 1e7 else col["vel"]
    v_outer = 0.5 * (v_center[:-1] + v_center[1:])
    v_outer = np.concatenate(
        [v_outer, [2.0 * v_outer[-1] - v_outer[-2]]]
    )
    v_inner0 = max(2.0 * v_center[0] - v_outer[0], 0.5 * v_outer[0])
    edges = np.concatenate([[v_inner0], v_outer])
    geometry = Radial1DGeometry.from_velocity_grid(edges, t_exp)
    density = density_after_time(col["dens"], t0, t_exp)

    elements, fractions = [], []
    isotopes = {}
    for name in columns:
        if not name.startswith("X_"):
            continue
        label = name[2:]
        # Blondin labels isotopes as 56Ni0 / 56Ni etc.
        m_iso = re.match(r"^(\d+)([A-Z][a-z]?)0?$", label)
        if m_iso:
            isotopes[f"{m_iso.group(2)}{m_iso.group(1)}"] = col[name]
        elif label in SYMBOL_TO_Z:
            elements.append(SYMBOL_TO_Z[label])
            fractions.append(col[name])
    if isotopes:
        elements, mass_fractions = fold_isotopes_into_elements(
            elements, fractions, isotopes, max(t_exp - t0, 0.0)
        )
    else:
        order = np.argsort(elements)
        elements = np.asarray(elements)[order]
        mass_fractions = np.stack([fractions[i] for i in order])
    t_rad = col.get("temp")
    return _assemble_state(
        geometry, elements, mass_fractions, density, config,
        t_radiative=t_rad,
    )


# ---------------------------------------------------------------------------
# SNEC


def read_snec_xg(path: str):
    """SNEC .xg profile file: repeated '"Time = <t>' blocks each followed by
    a whitespace table (reference io/model/snec/xg_files.py).

    Returns (timestamps (T,) seconds, blocks list of (rows, cols) arrays)."""
    timestamps = []
    blocks = []
    current = None
    with open(path) as fh:
        for ln in fh:
            s = ln.strip()
            if s.startswith('"Time') or s.startswith("Time"):
                m = re.search(r"=\s*([\d.eE+-]+)", s)
                timestamps.append(float(m.group(1)))
                current = []
                blocks.append(current)
            elif s and current is not None:
                current.append([float(x) for x in s.split()])
    return (
        np.asarray(timestamps),
        [np.asarray(b) for b in blocks if b],
    )


def simulation_state_from_snec(
    xg_path: str,
    config,
    columns=("radius", "velocity", "density", "temperature"),
    composition=None,
    snapshot_time: float | None = None,
) -> SimulationState:
    """SNEC hydro profile -> SimulationState.

    Picks the snapshot nearest ``snapshot_time`` (default: time_explosion),
    maps radius to homologous velocity edges via r/t, and takes uniform or
    per-shell ``composition`` ({'Si': array|float, ...}).
    """
    t_exp = config.supernova.time_explosion
    times, blocks = read_snec_xg(xg_path)
    target = t_exp if snapshot_time is None else snapshot_time
    i_snap = int(np.argmin(np.abs(times - target)))
    blk = blocks[i_snap]
    col = {name: blk[:, i] for i, name in enumerate(columns)}

    v = col["velocity"]
    # enforce monotone positive outflow for the radial grid
    keep = np.concatenate([[True], np.diff(col["radius"]) > 0])
    v = np.maximum.accumulate(np.abs(v[keep]))
    v = np.where(np.diff(np.concatenate([[0.0], v])) <= 0,
                 v + np.arange(len(v)) * 1e-6 * max(v.max(), 1.0), v)
    geometry = Radial1DGeometry.from_velocity_grid(v, t_exp)
    rho = col["density"][keep][1:]
    density = density_after_time(rho, times[i_snap], t_exp)
    t_rad = (
        col["temperature"][keep][1:] if "temperature" in col else None
    )

    S = geometry.no_of_shells
    composition = composition or {"H": 0.7, "He": 0.3}
    elements, fractions = [], []
    for sym, val in composition.items():
        elements.append(SYMBOL_TO_Z[sym])
        arr = np.asarray(val, dtype=np.float64)
        fractions.append(np.full(S, float(arr)) if arr.ndim == 0 else arr)
    order = np.argsort(elements)
    elements = np.asarray(elements)[order]
    mass_fractions = np.stack([fractions[i] for i in order])
    return _assemble_state(
        geometry, elements, mass_fractions, density, config,
        t_radiative=t_rad,
    )


# ---------------------------------------------------------------------------
# Arepo (3-D SPH/moving-mesh snapshot -> 1-D profile)


def arepo_cone_profile(
    position,  # (3, N) cm, explosion-centred
    velocity,  # (3, N) cm/s
    density,  # (N,) g/cm^3
    mass,  # (N,) g
    xnuc,  # dict: species -> (N,) mass fraction
    opening_angle: float = 20.0,
    direction: str = "+x",
    inner_radius: float | None = None,
    outer_radius: float | None = None,
):
    """Cone-selected radial profile from a 3-D snapshot.

    Mirrors the reference's ``create_cone_profile``
    (io/model/arepo/utils.py:18-210): select cells inside a cone of the
    given total opening angle around the +/-x axis, sort by radius, return
    (radius, |v|, rho, mass, xnuc-profiles) arrays.
    """
    pos = np.asarray(position, dtype=np.float64)
    vel = np.asarray(velocity, dtype=np.float64)
    axis = 0
    sign = 1.0 if direction.endswith("x") and not direction.startswith("-") \
        else -1.0
    ax = pos[axis] * sign
    perp = np.sqrt(
        pos[(axis + 1) % 3] ** 2 + pos[(axis + 2) % 3] ** 2
    )
    dist = np.tan(np.radians(opening_angle) / 2.0) * np.abs(ax)
    mask = (ax > 0) & (perp <= dist)
    r = np.sqrt((pos**2).sum(axis=0))[mask]
    vmag = np.sqrt((vel**2).sum(axis=0))[mask]
    rho = np.asarray(density, dtype=np.float64)[mask]
    mss = np.asarray(mass, dtype=np.float64)[mask]
    xn = {k: np.asarray(v, dtype=np.float64)[mask] for k, v in xnuc.items()}
    if inner_radius is not None:
        keep = r >= inner_radius
        r, vmag, rho, mss = r[keep], vmag[keep], rho[keep], mss[keep]
        xn = {k: v[keep] for k, v in xn.items()}
    if outer_radius is not None:
        keep = r <= outer_radius
        r, vmag, rho, mss = r[keep], vmag[keep], rho[keep], mss[keep]
        xn = {k: v[keep] for k, v in xn.items()}
    if len(r) == 0:
        raise ValueError("no cells remain inside the cone/radius cuts")
    order = np.argsort(r)
    return (
        r[order], vmag[order], rho[order], mss[order],
        {k: v[order] for k, v in xn.items()},
    )


def rebin_arepo_profile(r, v, rho, mass, xnuc, n_shells: int):
    """Rebin a sorted cone profile onto ``n_shells`` equal-cell-count radial
    shells with mass-weighted averages (reference rebin_profile,
    io/model/arepo/utils.py:375-470)."""
    edges_idx = np.linspace(0, len(r), n_shells + 1).astype(int)
    v_out = np.empty(n_shells)
    rho_out = np.empty(n_shells)
    xn_out = {k: np.empty(n_shells) for k in xnuc}
    for s in range(n_shells):
        a, b = edges_idx[s], max(edges_idx[s + 1], edges_idx[s] + 1)
        w = mass[a:b]
        wt = w.sum()
        v_out[s] = (v[a:b] * w).sum() / wt
        rho_out[s] = rho[a:b].mean()
        for k in xnuc:
            xn_out[k][s] = (xnuc[k][a:b] * w).sum() / wt
    v_out = np.maximum.accumulate(v_out)
    return v_out, rho_out, xn_out


def simulation_state_from_arepo(
    position, velocity, density, mass, xnuc, snapshot_time: float,
    config, n_shells: int = 20, opening_angle: float = 20.0,
    inner_radius=None, outer_radius=None, profile: str = "cone",
) -> SimulationState:
    """3-D Arepo-style snapshot arrays -> 1-D SimulationState.

    ``xnuc`` keys may be element symbols or isotope labels ('Ni56');
    isotopes are decayed from snapshot_time to time_explosion.
    ``profile``: 'cone' (reference create_cone_profile) or 'full'
    (angle-averaged over all cells, reference create_full_profile).
    """
    from tardis_torch.model.decay import fold_isotopes_into_elements

    t_exp = config.supernova.time_explosion
    if profile == "cone":
        prof = arepo_cone_profile(
            position, velocity, density, mass, xnuc,
            opening_angle=opening_angle,
            inner_radius=inner_radius, outer_radius=outer_radius,
        )
    elif profile == "full":
        prof = arepo_full_profile(
            position, velocity, density, mass, xnuc,
            inner_radius=inner_radius, outer_radius=outer_radius,
        )
    else:
        raise ValueError("profile must be 'cone' or 'full'")
    v_sh, rho_sh, xn_sh = rebin_arepo_profile(*prof, n_shells=n_shells)
    v_inner0 = max(v_sh[0] - (v_sh[1] - v_sh[0]), 0.5 * v_sh[0])
    edges = np.concatenate([[v_inner0], v_sh])
    geometry = Radial1DGeometry.from_velocity_grid(edges, t_exp)
    density_now = density_after_time(rho_sh, snapshot_time, t_exp)

    elem_cols, iso_cols = _split_element_isotope_columns(xn_sh.keys())
    elements = list(elem_cols.values())
    fractions = [xn_sh[name] for name in elem_cols]
    if iso_cols:
        elements, mass_fractions = fold_isotopes_into_elements(
            elements, fractions, {k: xn_sh[k] for k in iso_cols},
            max(t_exp - snapshot_time, 0.0),
        )
    else:
        order = np.argsort(elements)
        elements = np.asarray(elements)[order]
        mass_fractions = np.stack([fractions[i] for i in order])
    return _assemble_state(
        geometry, elements, mass_fractions, density_now, config
    )


# --- SNEC full-output directory (reference io/model/snec/snec_output.py) --

# quantity/file lists mirroring the reference's parser_config YAMLs
# (snec_xg_output_quantities.yml etc.)
SNEC_XG_QUANTITIES = (
    "vel", "rho", "temp", "logT", "tau", "lum", "p_rad", "press",
)
SNEC_INITIAL_COMPOSITION = (
    "H_init_frac", "He_init_frac", "C_init_frac", "O_init_frac",
    "Ni_init_frac",
)
SNEC_INITIAL_QUANTITIES = (
    "rad_initial", "rho_initial", "mass_initial", "press_initial",
    "delta_mass_initial",
)
SNEC_EM_OUTPUT = (
    "lum_observed", "lum_photo", "vel_photo", "mass_lumshell",
    "mass_photo", "Ni_total_luminosity", "T_eff",
)
SNEC_EM_INDEX_OUTPUT = ("index_lumshell", "index_photo")


@dataclass
class SNECOutput:
    """Complete SNEC explosion-simulation output
    (reference snec_output.py SNECOutput; numpy instead of
    pandas/xarray).

    - ``timestamps`` (T,) and ``profiles``: {quantity: (T, cells)} merged
      radial profiles from the per-quantity .xg files (plus 'radius' and
      'enclosed_mass' from mass.xg);
    - ``initial_composition`` / ``initial_quantities``: {name: (cells,)};
    - ``em_output``: {'time': (Tem,), name: (Tem,)} photospheric time
      series.
    """

    timestamps: np.ndarray
    profiles: dict
    initial_composition: dict
    initial_quantities: dict
    em_output: dict


def _read_snec_dat(path):
    data = np.atleast_2d(np.loadtxt(path))
    return data[:, 0], data[:, 1]


def read_snec_output(snec_output_dir: str) -> SNECOutput:
    """Read a complete SNEC run directory (expects an ``output/``
    subdirectory with mass.xg, {quantity}.xg, and {name}.dat files;
    reference read_snec_output, snec_output.py:312-335).  Missing optional
    quantity files are skipped with a warning; mass.xg is required."""
    import logging
    import os

    log = logging.getLogger(__name__)
    out = os.path.join(snec_output_dir, "output")
    t_mass, mass_blocks = read_snec_xg(os.path.join(out, "mass.xg"))
    cells = len(mass_blocks[0])
    profiles = {
        "radius": np.stack([b[:, 0] for b in mass_blocks]),
        "enclosed_mass": np.stack([b[:, 1] for b in mass_blocks]),
    }
    for q in SNEC_XG_QUANTITIES:
        path = os.path.join(out, f"{q}.xg")
        if not os.path.exists(path):
            log.warning("SNEC output missing %s.xg — skipped", q)
            continue
        t_q, blocks = read_snec_xg(path)
        if len(t_q) != len(t_mass) or not np.allclose(t_q, t_mass):
            raise ValueError(
                f"time stamps of {q}.xg do not match mass.xg"
            )
        profiles[q] = np.stack([b[:, 1] for b in blocks])
        if profiles[q].shape[1] != cells:
            raise ValueError(f"{q}.xg cell count mismatch")

    def read_group(names, first_col):
        group = {}
        ref_first = None
        for name in names:
            path = os.path.join(out, f"{name}.dat")
            if not os.path.exists(path):
                log.warning("SNEC output missing %s.dat — skipped", name)
                continue
            first, vals = _read_snec_dat(path)
            if ref_first is None:
                ref_first = first
                group[first_col] = first
            elif not np.allclose(first, ref_first):
                raise ValueError(f"{name}.dat {first_col} grid mismatch")
            group[name] = vals
        return group

    return SNECOutput(
        timestamps=t_mass,
        profiles=profiles,
        initial_composition=read_group(
            SNEC_INITIAL_COMPOSITION, "cell_id"
        ),
        initial_quantities=read_group(SNEC_INITIAL_QUANTITIES, "cell_id"),
        em_output=read_group(
            SNEC_EM_OUTPUT + SNEC_EM_INDEX_OUTPUT, "time"
        ),
    )


def simulation_state_from_snec_output(
    snec_output_dir: str,
    config,
    snapshot_time: float | None = None,
) -> SimulationState:
    """Full SNEC output directory -> SimulationState.

    Unlike :func:`simulation_state_from_snec` (single .xg profile +
    hand-supplied composition), this uses the run's own per-cell initial
    composition files and the velocity/density/temperature profiles of
    the snapshot nearest ``snapshot_time`` (default: time_explosion).
    """
    t_exp = config.supernova.time_explosion
    snec = read_snec_output(snec_output_dir)
    target = t_exp if snapshot_time is None else snapshot_time
    i = int(np.argmin(np.abs(snec.timestamps - target)))

    v = snec.profiles["vel"][i]
    keep = np.concatenate(
        [[True], np.diff(snec.profiles["radius"][i]) > 0]
    )
    v = np.maximum.accumulate(np.abs(v[keep]))
    v = np.where(
        np.diff(np.concatenate([[0.0], v])) <= 0,
        v + np.arange(len(v)) * 1e-6 * max(v.max(), 1.0), v,
    )
    geometry = Radial1DGeometry.from_velocity_grid(v, t_exp)
    density = density_after_time(
        snec.profiles["rho"][i][keep][1:], snec.timestamps[i], t_exp
    )
    t_rad = (
        snec.profiles["temp"][i][keep][1:]
        if "temp" in snec.profiles else None
    )

    # per-cell composition from the *_init_frac files; shells are the
    # inter-edge intervals, so average the two bounding cells
    comp = snec.initial_composition
    elements, fractions = [], []
    for name in SNEC_INITIAL_COMPOSITION:
        if name not in comp:
            continue
        sym = name.split("_")[0]
        frac = comp[name][keep]
        elements.append(SYMBOL_TO_Z[sym])
        fractions.append(0.5 * (frac[:-1] + frac[1:]))
    if not elements:
        raise ValueError(
            "SNEC output has no *_init_frac composition files"
        )
    order = np.argsort(elements)
    elements = np.asarray(elements)[order]
    mass_fractions = np.stack([fractions[j] for j in order])
    tot = mass_fractions.sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        mass_fractions = np.where(tot > 0, mass_fractions / tot, 0.0)
    return _assemble_state(
        geometry, elements, mass_fractions, density, config,
        t_radiative=t_rad,
    )

@dataclass
class ArepoData:
    """Arepo snapshot container (reference io/model/arepo/data.py:8-61;
    cgs floats instead of astropy quantities)."""

    time: float  # s
    position: np.ndarray  # (3, N) cm
    velocities: np.ndarray  # (3, N) cm/s
    densities: np.ndarray  # (N,) g/cm^3
    mass: np.ndarray  # (N,) g
    isotope_dict: dict  # species -> (N,) mass fraction

    @property
    def volume(self) -> np.ndarray:
        return self.mass / self.densities

    @property
    def species(self) -> list:
        return list(self.isotope_dict.keys())


def arepo_full_profile(
    position, velocity, density, mass, xnuc,
    inner_radius=None, outer_radius=None,
):
    """Angle-averaged radial profile from ALL snapshot cells (reference
    create_full_profile, io/model/arepo/utils.py:212-374) — same return
    convention as :func:`arepo_cone_profile`."""
    pos = np.asarray(position, dtype=np.float64)
    vel = np.asarray(velocity, dtype=np.float64)
    r = np.sqrt((pos**2).sum(axis=0))
    vmag = np.sqrt((vel**2).sum(axis=0))
    rho = np.asarray(density, dtype=np.float64)
    mss = np.asarray(mass, dtype=np.float64)
    xn = {k: np.asarray(v, dtype=np.float64) for k, v in xnuc.items()}
    keep = np.ones(len(r), bool)
    if inner_radius is not None:
        keep &= r >= inner_radius
    if outer_radius is not None:
        keep &= r <= outer_radius
    if not keep.any():
        raise ValueError("no cells remain inside the radius cuts")
    r, vmag, rho, mss = r[keep], vmag[keep], rho[keep], mss[keep]
    xn = {k: v[keep] for k, v in xn.items()}
    order = np.argsort(r)
    return (
        r[order], vmag[order], rho[order], mss[order],
        {k: v[order] for k, v in xn.items()},
    )


def arepo_export_csvy(
    filename: str,
    velocity_edges: np.ndarray,  # (S+1,) cm/s shell-boundary velocities
    density: np.ndarray,  # (S,) g/cm^3
    xnuc: dict,  # species -> (S,) mass fraction
    time_days: float,
    overwrite: bool = False,
) -> str:
    """Write a rebinned Arepo profile as a TARDIS CSVY model file
    (reference export_profile_to_csvy, io/model/arepo/utils.py:551-667).

    The output round-trips through the port's own CSVY reader.
    Follows the reference's convention: one header row per shell boundary,
    with density/abundances of row i describing the shell bounded below by
    row i-1 (the first row's non-velocity entries are placeholders).
    Returns the actual filename written (suffix collisions get _N).
    """
    import os

    base, ext = os.path.splitext(filename)
    if ext != ".csvy":
        base = filename
    fname = base + ".csvy"
    if os.path.exists(fname) and not overwrite:
        i = 0
        while os.path.exists(f"{base}_{i}.csvy"):
            i += 1
        fname = f"{base}_{i}.csvy"

    S = len(density)
    if len(velocity_edges) != S + 1:
        raise ValueError("need S+1 velocity edges for S shells")
    species = list(xnuc.keys())
    lines = [
        "---",
        "name: csvy_full",
        f"model_density_time_0: {time_days:g} day",
        f"model_isotope_time_0: {time_days:g} day",
        "description: Config file for TARDIS from Arepo snapshot.",
        "tardis_model_config_version: v1.0",
        "datatype:",
        "  fields:",
        "    -  name: velocity",
        "       unit: cm/s",
        "       desc: velocities of shell outer bounderies.",
        "    -  name: density",
        "       unit: g/cm^3",
        "       desc: density of shell.",
    ]
    for spec in species:
        lines += [
            f"    -  name: {spec.capitalize()}",
            f"       desc: fractional {spec.capitalize()} abundance.",
        ]
    lines += ["---", ",".join(["velocity", "density"] +
                              [s.capitalize() for s in species])]
    # first row: inner boundary (density/abundance placeholders)
    row0 = [f"{velocity_edges[0]:.8e}", f"{density[0]:.8e}"] + [
        f"{xnuc[s][0]:.8e}" for s in species
    ]
    lines.append(",".join(row0))
    for i in range(S):
        row = [f"{velocity_edges[i + 1]:.8e}", f"{density[i]:.8e}"] + [
            f"{xnuc[s][i]:.8e}" for s in species
        ]
        lines.append(",".join(row))
    with open(fname, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return fname


@dataclass
class SNECIsotopeProfile:
    """SNEC initial isotope-composition profile
    (reference io/model/snec/snec_input.py:9-63)."""

    enclosed_mass: np.ndarray  # (cells,) g
    radius: np.ndarray  # (cells,) cm
    # (cells, n_iso) mass fractions + the isotope labels per column
    mass_fractions: np.ndarray
    isotopes: list  # e.g. ['Ni56', 'He4', ...]


def read_snec_isotope_profile(path: str) -> SNECIsotopeProfile:
    """Read a SNEC ``.iso`` isotope-profile file (reference
    read_snec_isotope_profile, snec_input.py:65-112): header line
    ``rows cols``, then mass-number and neutron-number rows (Fortran
    'd' exponents), then ``enclosed_mass radius X_1 X_2 ...`` rows."""
    from tardis_torch.atomic.atom_data import ATOMIC_SYMBOLS

    with open(path) as fh:
        rows, cols = map(int, fh.readline().split())
        a_num = np.array(
            [float(x) for x in fh.readline().replace("d", "e").split()]
        ).astype(int)
        n_num = np.array(
            [float(x) for x in fh.readline().replace("d", "e").split()]
        ).astype(int)
        z_num = a_num - n_num
        data = np.atleast_2d(
            np.loadtxt((ln.replace("d", "e") for ln in fh))
        )
    mf = data[:, 2:]
    if mf.shape != (rows, cols):
        raise ValueError(
            f"isotope table {mf.shape} does not match header ({rows}, "
            f"{cols})"
        )
    labels = [
        f"{ATOMIC_SYMBOLS[z - 1]}{a}" if 1 <= z <= len(ATOMIC_SYMBOLS)
        else f"Z{z}A{a}"
        for z, a in zip(z_num, a_num)
    ]
    return SNECIsotopeProfile(
        enclosed_mass=data[:, 0],
        radius=data[:, 1],
        mass_fractions=mf,
        isotopes=labels,
    )
