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

from tardis_torch.atomic.atom_data import ATOMIC_MASSES, AtomData
from tardis_torch.constants import H, M_U

EV = 1.602176634e-12  # erg


def make_synthetic_atom_data(
    atomic_numbers=(8, 12, 14, 16, 18, 20),
    max_ion_stage: int = 3,
    n_levels: int = 25,
    max_level_jump: int | None = None,
    seed: int = 42,
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
        zeta_data=zeta_data,
    )
