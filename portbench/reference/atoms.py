"""The benchmark's atomic data: the synthetic recipe that makes it, and
the reference's own preparation of it (species, macro-atom transitions).

``make_atom_data(recipe)`` builds hydrogen-like level ladders per ion with
every downward line inside a jump window and pseudo-random oscillator
strengths from ``recipe["seed"]`` (the stand-in for a carsus file, which
the repository does not hold).  It returns plain arrays, lines sorted by
frequency descending and levels by (Z, ion, level); the harness hands the
same arrays to the program and to the reference.
"""

from dataclasses import dataclass

import numpy as np

from portbench.reference.constants import ATOMIC_MASSES, H, M_U

EV = 1.602176634e-12  # erg

# macro-atom transition types (Lucy 2002, 2003)
EMISSION, INTERNAL_DOWN, INTERNAL_UP = -1, 0, 1


def _chi(z, stage):
    """Ionization energy of stage - 1 -> stage."""
    return 13.6 * EV * (stage**1.8) * (1.0 + z / 20.0)


def make_atom_data(recipe: dict) -> dict:
    zs = tuple(int(z) for z in recipe["atomic_numbers"])
    max_ion_stage = int(recipe["max_ion_stage"])
    n_levels = int(recipe["n_levels"])
    jump = recipe.get("max_level_jump")
    rng = np.random.RandomState(int(recipe["seed"]))
    ks = np.arange(n_levels)
    # every downward pair (lower, upper) inside the jump window, upper
    # ascending, then lower ascending: the order of the strengths' draws
    up = np.repeat(ks, [u - (0 if jump is None else max(0, u - int(jump)))
                        for u in ks])
    lo = np.concatenate([np.arange(0 if jump is None else
                                   max(0, u - int(jump)), u) for u in ks])

    lv_z, lv_ion, lv_k, lv_e, lv_g, lv_meta = [], [], [], [], [], []
    ln_z, ln_ion, ln_lo, ln_up, ln_nu, ln_f = [], [], [], [], [], []
    ion_rows = []
    for z in zs:
        n_stages = min(z, max_ion_stage)
        ion_rows += [(z, j, _chi(z, j)) for j in range(1, n_stages + 1)]
        for ion in range(n_stages):
            energies = _chi(z, ion + 1) * (1.0 - 1.0 / (1.0 + ks) ** 2)
            for a, v in zip((lv_z, lv_ion, lv_k, lv_e, lv_g, lv_meta),
                            (z, ion, ks, energies, 2.0 * (ks + 1) ** 2,
                             ks < 2)):
                a.append(np.broadcast_to(v, (n_levels,)))
            # energies rise with k, so every pair is a line
            # the power in C's pow, one line at a time: numpy's vector
            # power may round otherwise
            f_lu = np.array([10.0 ** x for x in
                             rng.uniform(-4.0, 0.0, size=len(up)).tolist()])
            for a, v in zip((ln_z, ln_ion, ln_lo, ln_up, ln_nu, ln_f),
                            (z, ion, lo, up,
                             (energies[up] - energies[lo]) / H, f_lu)):
                a.append(np.broadcast_to(v, (len(up),)))
        # the bare next stage closes the Saha ladder with one level
        for a, v in zip((lv_z, lv_ion, lv_k, lv_e, lv_g, lv_meta),
                        (z, n_stages, 0, 0.0, 1.0, True)):
            a.append(np.array([v]))

    lz, lion, lk = (np.concatenate(a).astype(np.int64)
                    for a in (lv_z, lv_ion, lv_k))
    lorder = np.lexsort((lk, lion, lz))
    lz, lion, lk = lz[lorder], lion[lorder], lk[lorder]
    flat = {key: i for i, key in enumerate(zip(lz.tolist(), lion.tolist(),
                                               lk.tolist()))}
    kz, kion, klo, kup = (np.concatenate(a).astype(np.int64)
                          for a in (ln_z, ln_ion, ln_lo, ln_up))
    nu = np.concatenate(ln_nu)
    order = np.argsort(-nu, kind="stable")
    kz, kion, klo, kup = kz[order], kion[order], klo[order], kup[order]

    def level_index(k):
        return np.array([flat[key] for key in zip(
            kz.tolist(), kion.tolist(), k.tolist())], dtype=np.int32)

    zs_sorted = np.asarray(sorted(set(zs)))
    photo_ion = _photo_ion_tables(
        recipe.get("continuum_species", ()), max_ion_stage, n_levels,
        int(recipe.get("n_photo_ion_points", 16)), flat)
    zeta_t = np.linspace(2000.0, 40000.0, 20)
    return dict(
        atomic_numbers=zs_sorted,
        masses=np.array([ATOMIC_MASSES[z - 1] for z in zs_sorted]) * M_U,
        ionization_z=np.array([r[0] for r in ion_rows], dtype=np.int64),
        ionization_ion=np.array([r[1] for r in ion_rows], dtype=np.int64),
        ionization_energy=np.array([r[2] for r in ion_rows]),
        level_z=lz,
        level_ion=lion,
        level_number=lk,
        level_energy=np.concatenate(lv_e).astype(np.float64)[lorder],
        level_g=np.concatenate(lv_g).astype(np.float64)[lorder],
        level_meta=np.concatenate(lv_meta).astype(bool)[lorder],
        line_nu=nu[order],
        line_f_lu=np.concatenate(ln_f)[order],
        line_lower_idx=level_index(klo),
        line_upper_idx=level_index(kup),
        line_z=kz,
        line_ion=kion,
        meta={"source": "synthetic", "seed": int(recipe["seed"])},
        photo_ion=photo_ion,
        two_photon=None,
        collision=None,
        # zeta = 1 on a grid: nebular ionization reduces to W-scaled Saha
        zeta_data={(int(z), j): (zeta_t, np.ones_like(zeta_t))
                   for z in zs_sorted
                   for j in range(1, min(int(z), max_ion_stage) + 1)},
    )


def _photo_ion_tables(species, max_ion_stage, n_levels, n_points, flat):
    """Hydrogenic bound-free cross-sections for every level of each
    continuum species (Z, ion): n_points frequencies from each threshold
    to 30 times it, geometric, sigma_0 (nu_th / nu)^3 with sigma_0 =
    6.3e-18 / (level + 1) cm^2; continua by threshold descending.  None
    without continuum species."""
    rows = []
    for z, ion in species:
        z, ion = int(z), int(ion)
        if ion >= min(z, max_ion_stage):
            continue
        chi_next = _chi(z, ion + 1)
        energies = chi_next * (1.0 - 1.0 / (1.0 + np.arange(n_levels)) ** 2)
        for k in range(n_levels):
            nu_th = (chi_next - energies[k]) / H
            nus = nu_th * np.geomspace(1.0, 30.0, n_points)
            sigma0 = 6.3e-18 / (k + 1)
            rows.append((nu_th, z, ion, k, flat[(z, ion, k)], nus,
                         sigma0 * (nu_th / nus) ** 3))
    if not rows:
        return None
    rows.sort(key=lambda r: -r[0])
    refs = np.zeros(len(rows) + 1, dtype=np.int32)
    np.cumsum([len(r[5]) for r in rows], out=refs[1:])
    return dict(
        cont_z=np.array([r[1] for r in rows], dtype=np.int64),
        cont_ion=np.array([r[2] for r in rows], dtype=np.int64),
        cont_level=np.array([r[3] for r in rows], dtype=np.int64),
        level_flat_idx=np.array([r[4] for r in rows], dtype=np.int32),
        block_references=refs,
        nu=np.concatenate([r[5] for r in rows]),
        x_sect=np.concatenate([r[6] for r in rows]),
    )


@dataclass
class Atoms:
    """The arrays the reference reads, restricted to the model's elements."""

    level_energy: np.ndarray
    level_g: np.ndarray
    species: np.ndarray  # (Sp, 2) unique (Z, ion), sorted
    level_species: np.ndarray  # (N,) index into species
    ion_z: np.ndarray
    ion_stage: np.ndarray
    ion_energy: np.ndarray
    masses: dict  # Z -> g
    line_nu: np.ndarray  # (L,) Hz, descending
    line_f_lu: np.ndarray
    line_lower: np.ndarray  # (L,) level index
    line_upper: np.ndarray
    # macro atom: transitions grouped by source macro level
    m_src: np.ndarray  # (T,)
    m_type: np.ndarray
    m_coef: np.ndarray
    m_dest: np.ndarray
    m_line: np.ndarray
    n_macro: int
    line_macro_upper: np.ndarray  # (L,) macro level of each line's upper
    macro_levels: np.ndarray  # (M,) level index of each macro level
    level_z: np.ndarray  # (N,)
    level_ion: np.ndarray
    level_number: np.ndarray
    level_meta: np.ndarray
    line_z: np.ndarray  # (L,)
    line_ion: np.ndarray
    # bound-free continua of the selected elements (None: none): cont_z,
    # cont_ion, cont_level, level (index), block_references, nu, x_sect
    photo_ion: dict | None


def prepare(raw: dict, elements) -> Atoms:
    """Select ``elements``; species ids; macro-atom transitions with the
    coefficients of Lucy (2002, 2003): emission 2 nu^2 / c^2 g_l / g_u f_lu
    (e_u - e_l), internal down the same times e_l, internal up f_lu / (h nu)
    e_l, each multiplied at run time by beta_sobolev (and, going up, by the
    stimulated-emission factor and J_blue)."""
    from portbench.reference.constants import C

    wanted = np.asarray(sorted(set(int(z) for z in elements)))
    lmask = np.isin(raw["level_z"], wanted)
    new_index = -np.ones(len(lmask), np.int64)
    new_index[lmask] = np.arange(int(lmask.sum()))
    kmask = np.isin(raw["line_z"], wanted)
    imask = np.isin(raw["ionization_z"], wanted)
    lz, lion = raw["level_z"][lmask], raw["level_ion"][lmask]
    species, level_species = np.unique(np.stack([lz, lion], 1), axis=0,
                                       return_inverse=True)
    e = raw["level_energy"][lmask]
    g = raw["level_g"][lmask]
    lo = new_index[raw["line_lower_idx"][kmask]]
    up = new_index[raw["line_upper_idx"][kmask]]
    nu = raw["line_nu"][kmask]
    f_lu = raw["line_f_lu"][kmask]

    n_lv = len(e)
    takes_part = np.zeros(n_lv, bool)
    takes_part[lo] = takes_part[up] = True
    macro_of = -np.ones(n_lv, np.int64)
    macro_of[takes_part] = np.arange(int(takes_part.sum()))
    L = len(nu)
    lines = np.arange(L)
    down = 2.0 * nu**2 / C**2 * (g[lo] / g[up]) * f_lu
    src = np.concatenate([macro_of[up], macro_of[up], macro_of[lo]])
    ttype = np.concatenate([np.full(L, EMISSION), np.full(L, INTERNAL_DOWN),
                            np.full(L, INTERNAL_UP)])
    coef = np.concatenate([down * (e[up] - e[lo]), down * e[lo],
                           f_lu / (H * nu) * e[lo]])
    dest = np.concatenate([np.full(L, -1), macro_of[lo], macro_of[up]])
    line = np.concatenate([lines, lines, lines])
    order = np.lexsort((line, ttype, src))
    return Atoms(
        level_energy=e, level_g=g, species=species,
        level_species=level_species.ravel(),
        ion_z=raw["ionization_z"][imask],
        ion_stage=raw["ionization_ion"][imask],
        ion_energy=raw["ionization_energy"][imask],
        masses={int(z): float(m) for z, m in
                zip(raw["atomic_numbers"], raw["masses"])},
        line_nu=nu, line_f_lu=f_lu, line_lower=lo, line_upper=up,
        m_src=src[order], m_type=ttype[order], m_coef=coef[order],
        m_dest=dest[order], m_line=line[order],
        n_macro=int(takes_part.sum()),
        line_macro_upper=macro_of[up],
        macro_levels=np.nonzero(takes_part)[0],
        level_z=lz, level_ion=lion,
        level_number=raw["level_number"][lmask],
        level_meta=raw["level_meta"][lmask],
        line_z=raw["line_z"][kmask], line_ion=raw["line_ion"][kmask],
        photo_ion=_select_continua(raw.get("photo_ion"), wanted, new_index),
    )


def _select_continua(pi, wanted, new_index):
    if pi is None:
        return None
    keep = np.nonzero(np.isin(pi["cont_z"], wanted))[0]
    if not len(keep):
        return None
    refs = pi["block_references"]
    pts = np.concatenate([np.arange(refs[c], refs[c + 1]) for c in keep])
    new_refs = np.zeros(len(keep) + 1, dtype=np.int64)
    np.cumsum([refs[c + 1] - refs[c] for c in keep], out=new_refs[1:])
    return dict(cont_z=pi["cont_z"][keep], cont_ion=pi["cont_ion"][keep],
                cont_level=pi["cont_level"][keep],
                level=new_index[pi["level_flat_idx"][keep]],
                block_references=new_refs, nu=pi["nu"][pts],
                x_sect=pi["x_sect"][pts])
