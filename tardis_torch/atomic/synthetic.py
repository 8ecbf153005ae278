"""Deterministic synthetic atomic dataset generator.

The real kurucz/chianti atomic files are large external downloads; this module
generates a physically self-consistent stand-in (hydrogen-like level ladders,
all-downward line transitions with pseudo-random oscillator strengths) used by
the test-suite and benchmarks.  The structure exactly matches
:class:`tardis_torch.atomic.atom_data.AtomData`, so everything downstream
(plasma, opacities, transport) is exercised identically to a real dataset.
"""

from __future__ import annotations

import numpy as np

from tardis_torch.atomic.atom_data import (
    ATOMIC_MASSES,
    AtomData,
    CollisionData,
    PhotoIonizationData,
    TwoPhotonData,
)
from tardis_torch.constants import H, M_U

EV = 1.602176634e-12  # erg


def make_synthetic_atom_data(
    atomic_numbers=(8, 12, 14, 16, 18, 20),
    max_ion_stage: int = 3,
    n_levels: int = 25,
    max_level_jump: int | None = None,
    seed: int = 42,
    continuum_species=(),
    n_photo_ion_points: int = 16,
    collision_species=(),
) -> AtomData:
    """Build a synthetic AtomData.

    Parameters
    ----------
    atomic_numbers
        Elements to include (default: the tardis_example composition
        O/Mg/Si/S/Ar/Ca, docs/tardis_example.yml:20-26).
    max_ion_stage
        Ion stages 0..max_ion_stage-1 get level structure (plus the bare next
        stage with a single ground level for ionization balance).
    n_levels
        Levels per species; line count scales ~ n_levels^2 / 2 per species.
    max_level_jump
        If set, only transitions with (upper - lower) <= max_level_jump are
        kept (controls the line count).
    continuum_species
        (Z, ion) pairs for which hydrogenic photoionization cross-section
        tables are generated (sigma = sigma_0/(k+1) * (nu_th/nu)^3 on a
        geometric grid of ``n_photo_ion_points`` frequencies per level), with
        one 2s-like two-photon decay per species: the stand-in for the
        reference's ``photoionization_data`` and ``two_photon_data`` tables
        the Type IIP continuum workflow reads.
    collision_species
        (Z, ion) pairs for which tabulated collision strengths are made
        (every level with each of up to three levels below it, smooth and
        rising with T on a 5-point temperature grid): the stand-in for the
        reference's ``collision_data`` tables.
    """
    rng = np.random.RandomState(seed)

    level_rows = []  # (Z, ion, k, energy, g, meta)
    ion_rows = []  # (Z, j, chi)
    line_rows = []  # (Z, ion, lower_k, upper_k, nu, f_lu)

    for z in atomic_numbers:
        n_stages = min(int(z), max_ion_stage)
        for j in range(1, n_stages + 1):
            # ionization energy ion (j-1) -> j, monotonically increasing in j
            chi = 13.6 * EV * (j**1.8) * (1.0 + z / 20.0)
            ion_rows.append((z, j, chi))

        for ion in range(n_stages):
            chi_next = 13.6 * EV * ((ion + 1) ** 1.8) * (1.0 + z / 20.0)
            ks = np.arange(n_levels)
            energies = chi_next * (1.0 - 1.0 / (1.0 + ks) ** 2)
            gs = 2.0 * (ks + 1) ** 2
            metas = ks < 2
            for k in range(n_levels):
                level_rows.append((z, ion, k, energies[k], gs[k], metas[k]))

            # lines: all downward pairs within the jump window
            for u in range(1, n_levels):
                l_lo = 0 if max_level_jump is None else max(0, u - max_level_jump)
                for lo in range(l_lo, u):
                    d_e = energies[u] - energies[lo]
                    if d_e <= 0:
                        continue
                    nu = d_e / H
                    f_lu = 10.0 ** rng.uniform(-4.0, 0.0)
                    line_rows.append((z, ion, lo, u, nu, f_lu))

        # bare/top stage: single ground level so the Saha ladder closes
        level_rows.append((z, n_stages, 0, 0.0, 1.0, True))

    level_rows.sort(key=lambda r: (r[0], r[1], r[2]))
    lz = np.array([r[0] for r in level_rows], dtype=np.int64)
    lion = np.array([r[1] for r in level_rows], dtype=np.int64)
    lnum = np.array([r[2] for r in level_rows], dtype=np.int64)
    lene = np.array([r[3] for r in level_rows])
    lg = np.array([r[4] for r in level_rows])
    lmeta = np.array([r[5] for r in level_rows], dtype=bool)

    # flat level index lookup
    flat = {}
    for i in range(len(lz)):
        flat[(lz[i], lion[i], lnum[i])] = i

    line_rows.sort(key=lambda r: -r[4])  # nu descending
    line_nu = np.array([r[4] for r in line_rows])
    line_f_lu = np.array([r[5] for r in line_rows])
    line_z = np.array([r[0] for r in line_rows], dtype=np.int64)
    line_ion = np.array([r[1] for r in line_rows], dtype=np.int64)
    line_lower = np.array(
        [flat[(r[0], r[1], r[2])] for r in line_rows], dtype=np.int32
    )
    line_upper = np.array(
        [flat[(r[0], r[1], r[3])] for r in line_rows], dtype=np.int32
    )

    photo_ion = two_photon = None
    if continuum_species:
        photo_ion = _photo_ion_tables(continuum_species, max_ion_stage,
                                      n_levels, n_photo_ion_points, flat)
        two_photon = _two_photon_tables(continuum_species, flat, lene)
    collision = _collision_tables(collision_species, max_ion_stage, n_levels,
                                  flat)

    zs = np.asarray(sorted(set(int(z) for z in atomic_numbers)))
    zeta_t = np.linspace(2000.0, 40000.0, 20)
    zeta_data = {}
    for z in zs:
        for j in range(1, min(int(z), max_ion_stage) + 1):
            zeta_data[(int(z), j)] = (zeta_t, np.ones_like(zeta_t))

    return AtomData(
        atomic_numbers=zs,
        masses=np.array([ATOMIC_MASSES[z - 1] for z in zs]) * M_U,
        ionization_z=np.array([r[0] for r in ion_rows], dtype=np.int64),
        ionization_ion=np.array([r[1] for r in ion_rows], dtype=np.int64),
        ionization_energy=np.array([r[2] for r in ion_rows]),
        level_z=lz,
        level_ion=lion,
        level_number=lnum,
        level_energy=lene,
        level_g=lg,
        level_meta=lmeta,
        line_nu=line_nu,
        line_f_lu=line_f_lu,
        line_lower_idx=line_lower,
        line_upper_idx=line_upper,
        line_z=line_z,
        line_ion=line_ion,
        meta={"source": "synthetic", "seed": seed},
        photo_ion=photo_ion,
        two_photon=two_photon,
        collision=collision,
        zeta_data=zeta_data,
    )


def _collision_tables(collision_species, max_ion_stage, n_levels, flat
                      ) -> CollisionData | None:
    """Smooth, T-increasing strengths ~ O(1) / g_l between every level of
    each species and up to three levels below it."""
    lo_idx, up_idx, yg = [], [], []
    temps = np.array([2000.0, 5000.0, 10000.0, 20000.0, 40000.0])
    for z, ion in collision_species:
        if ion >= min(int(z), max_ion_stage):
            continue
        for u in range(1, n_levels):
            for lo in range(max(0, u - 3), u):
                lo_idx.append(flat[(z, ion, lo)])
                up_idx.append(flat[(z, ion, u)])
                yg.append((1.0 + 0.5 * lo + 0.2 * u) * (temps / 1e4) ** 0.3)
    if not lo_idx:
        return None
    return CollisionData(lower_flat=np.asarray(lo_idx, np.int32),
                         upper_flat=np.asarray(up_idx, np.int32),
                         temperatures=temps, yg=np.asarray(yg))


def _photo_ion_tables(continuum_species, max_ion_stage, n_levels, n_points,
                      flat) -> PhotoIonizationData | None:
    """Hydrogenic cross-sections for every level of each continuum species,
    in the reference's continuum order (threshold nu descending)."""
    rows = []  # (nu_threshold, z, ion, k, flat_idx, nus, xs)
    for z, ion in continuum_species:
        if ion >= min(int(z), max_ion_stage):
            continue
        chi_next = 13.6 * EV * ((ion + 1) ** 1.8) * (1.0 + z / 20.0)
        energies = chi_next * (1.0 - 1.0 / (1.0 + np.arange(n_levels)) ** 2)
        for k in range(n_levels):
            nu_th = (chi_next - energies[k]) / H
            nus = nu_th * np.geomspace(1.0, 30.0, n_points)
            sigma0 = 6.3e-18 / (k + 1)  # hydrogenic-like scale [cm^2]
            rows.append((nu_th, z, ion, k, flat[(z, ion, k)], nus,
                         sigma0 * (nu_th / nus) ** 3))
    if not rows:
        return None
    rows.sort(key=lambda r: -r[0])
    refs = np.zeros(len(rows) + 1, dtype=np.int32)
    np.cumsum([len(r[5]) for r in rows], out=refs[1:])
    return PhotoIonizationData(
        cont_z=np.array([r[1] for r in rows], dtype=np.int64),
        cont_ion=np.array([r[2] for r in rows], dtype=np.int64),
        cont_level=np.array([r[3] for r in rows], dtype=np.int64),
        level_flat_idx=np.array([r[4] for r in rows], dtype=np.int32),
        block_references=refs,
        nu=np.concatenate([r[5] for r in rows]),
        x_sect=np.concatenate([r[6] for r in rows]),
    )


def _two_photon_tables(continuum_species, flat, level_energy
                       ) -> TwoPhotonData | None:
    """One 2s-like -> ground two-photon decay per continuum species, with
    the H I 2s -> 1s Nussbaumer & Schmutz (1984) fit coefficients and
    total rate (A = 8.2249 1/s, hydrogenic Z^6 scaling)."""
    rows = []
    for z, ion in continuum_species:
        if (z, ion, 1) in flat and (z, ion, 0) in flat:
            nu0 = (level_energy[flat[(z, ion, 1)]]
                   - level_energy[flat[(z, ion, 0)]]) / H
            if nu0 > 0:
                rows.append((z, ion, 0, 1, 8.2249 * (ion + 1) ** 6, nu0,
                             0.88, 1.53, 0.8))
    if not rows:
        return None
    arr = np.asarray(rows, dtype=np.float64)
    return TwoPhotonData(
        z=arr[:, 0].astype(np.int64), ion=arr[:, 1].astype(np.int64),
        level_lower=arr[:, 2].astype(np.int64),
        level_upper=arr[:, 3].astype(np.int64),
        A_ul=arr[:, 4], nu0=arr[:, 5],
        alpha=arr[:, 6], beta=arr[:, 7], gamma=arr[:, 8],
    )
