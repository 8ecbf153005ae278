"""Atomic data container for the PyTorch radiative-transfer port.

Plays the role of the reference's ``AtomData``
(tardis/io/atom_data/base.py:33) but stores flat, dense numpy
arrays instead of pandas DataFrames so the plasma solver can run as batched
vectorized linear algebra and the transport tables upload directly to device.

Layout
------
Levels are flattened and sorted by (Z, ion, level_number).  Each level row
carries a ``species_id`` (index into the unique (Z, ion) list).  Lines are
sorted by frequency **descending** (the transport kernel's line-walk order,
mirroring the reference's ``line_list_nu``) and carry flat indices of their
lower/upper levels.

Macro-atom transition tables follow the Lucy (2002, 2003) scheme documented in
docs/physics_walkthrough/setup/plasma/macroatom.rst: per macro
level a block of transitions with a pre-computed coefficient that is multiplied
at runtime by beta_sobolev (and by J^b_lu * stimulated-emission factor for
internal-up transitions).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np

from tardis_torch.constants import C, H

# Transition types in the macro-atom block
# (reference: tardis/transport/montecarlo/macro_atom.py:19-27)
MACRO_EMISSION = -1
MACRO_INTERNAL_DOWN = 0
MACRO_INTERNAL_UP = 1

ATOMIC_SYMBOLS = [
    "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca",
    "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
]
SYMBOL_TO_Z = {s: i + 1 for i, s in enumerate(ATOMIC_SYMBOLS)}

# Mean atomic masses [amu] for Z = 1..30
ATOMIC_MASSES = np.array(
    [
        1.008, 4.0026, 6.94, 9.0122, 10.81, 12.011, 14.007, 15.999, 18.998,
        20.180, 22.990, 24.305, 26.982, 28.085, 30.974, 32.06, 35.45, 39.948,
        39.098, 40.078, 44.956, 47.867, 50.942, 51.996, 54.938, 55.845,
        58.933, 58.693, 63.546, 65.38,
    ]
)


@dataclass
class MacroAtomData:
    """Dense macro-atom transition tables (CSR layout over macro levels).

    ``coef`` is the pre-computed probability coefficient; runtime probability
    is ``coef * beta_sobolev[line]`` (and ``* stim * j_blue`` for internal-up).
    """

    # per transition (T,)
    coef: np.ndarray
    transition_type: np.ndarray  # int8: -1 emission, 0 internal down, 1 up
    destination_level_id: np.ndarray  # int32 macro level idx (emission: -1)
    transition_line_id: np.ndarray  # int32 line id of the associated line
    # per macro level (M+1,)
    block_references: np.ndarray  # int32 CSR offsets
    # per line (L,) -> macro level activated when the line absorbs
    line2macro_level_upper: np.ndarray
    # per macro level (M,) -> flat level index
    macro_flat_ids: np.ndarray | None = None

    @property
    def n_transitions(self) -> int:
        return len(self.coef)

    @property
    def n_macro_levels(self) -> int:
        return len(self.block_references) - 1


@dataclass
class CollisionData:
    """Tabulated thermally-averaged collision strengths.

    Counterpart of the reference's ``collision_data`` /
    ``collision_data_temperatures`` HDF tables consumed by YgData
    (tardis/plasma/properties/atomic.py:646): per (lower, upper) level
    pair, Upsilon_ij / g_lower tabulated over a temperature grid; the
    collisional rate coefficients follow Przybilla & Butler 2004 (A2):

        q_lu = BETA_COLL / sqrt(T_e) * yg * exp(-dE / k T_e)
        q_ul = BETA_COLL / sqrt(T_e) * yg * g_l / g_u
    """

    lower_flat: np.ndarray  # (Nc,) int32 flat level index (lower)
    upper_flat: np.ndarray  # (Nc,) int32
    temperatures: np.ndarray  # (Nt,) K, ascending
    yg: np.ndarray  # (Nc, Nt) Upsilon / g_lower

    def __len__(self):
        return len(self.lower_flat)


@dataclass
class TwoPhotonData:
    """Two-photon decay transitions (e.g. H I 2s -> 1s).

    Counterpart of the reference's ``atomic_data.two_photon_data`` table
    (tardis/io/atom_data/base.py:97-104: index (atomic_number, ion_number,
    level_number_lower, level_number_upper), columns A_ul [1/s], nu0 [Hz],
    alpha, beta, gamma — the Nussbaumer & Schmutz 1984 fit coefficients of
    the frequency-dependent decay rate A(y)).
    """

    z: np.ndarray  # (T,) int
    ion: np.ndarray  # (T,) int
    level_lower: np.ndarray  # (T,) int
    level_upper: np.ndarray  # (T,) int
    A_ul: np.ndarray  # (T,) float 1/s
    nu0: np.ndarray  # (T,) float Hz
    alpha: np.ndarray  # (T,) float
    beta: np.ndarray  # (T,) float
    gamma: np.ndarray  # (T,) float


@dataclass
class PhotoIonizationData:
    """Tabulated photoionization cross-sections (bound-free continua).

    Counterpart of the reference's ``atomic_data.photoionization_data``
    table as flat CSR blocks.  Continua are sorted by threshold frequency
    DESCENDING (the reference's ``level2continuum_idx`` order,
    tardis/iip_plasma/properties/continuum.py:1448-1452) and each
    continuum's frequency grid is ascending within its block.
    """

    # per continuum (C,), threshold-nu descending order
    cont_z: np.ndarray  # int
    cont_ion: np.ndarray  # int (lower ion stage, e.g. 0 for H I)
    cont_level: np.ndarray  # int level_number of the bound level
    level_flat_idx: np.ndarray  # int32 flat index of the bound level
    block_references: np.ndarray  # (C+1,) int32 offsets into point arrays
    # per tabulation point (P,)
    nu: np.ndarray  # Hz, ascending within each block
    x_sect: np.ndarray  # cm^2

    @property
    def n_continua(self) -> int:
        return len(self.cont_z)

    @property
    def nu_threshold(self) -> np.ndarray:
        return self.nu[self.block_references[:-1]]

    @property
    def nu_max(self) -> np.ndarray:
        return self.nu[self.block_references[1:] - 1]


@dataclass
class AtomData:
    """Flat-array atomic dataset.

    Attributes
    ----------
    All arrays are aligned: levels sorted by (Z, ion, level); lines sorted by
    nu descending.
    """

    # elements
    atomic_numbers: np.ndarray  # (E,) int, unique Z present
    masses: np.ndarray  # (E,) float, grams

    # ionization energies: chi[(Z, j)] = energy to ionize ion j-1 -> j [erg]
    ionization_z: np.ndarray  # (I,) int
    ionization_ion: np.ndarray  # (I,) int (1-based: energy for stage j)
    ionization_energy: np.ndarray  # (I,) float erg

    # levels (flattened, sorted)
    level_z: np.ndarray  # (N,) int
    level_ion: np.ndarray  # (N,) int (0 = neutral)
    level_number: np.ndarray  # (N,) int
    level_energy: np.ndarray  # (N,) float erg
    level_g: np.ndarray  # (N,) float
    level_meta: np.ndarray  # (N,) bool metastable

    # lines (sorted by nu DESC)
    line_nu: np.ndarray  # (L,) float Hz
    line_f_lu: np.ndarray  # (L,) float oscillator strength
    line_lower_idx: np.ndarray  # (L,) int32 flat level index (lower)
    line_upper_idx: np.ndarray  # (L,) int32 flat level index (upper)
    line_z: np.ndarray  # (L,) int
    line_ion: np.ndarray  # (L,) int

    # optional raw source (e.g. pandas frames) kept for HDF round trip
    meta: dict = field(default_factory=dict)

    # bound-free continua (None when the dataset carries no
    # photoionization tables; the Type IIP continuum workflow needs them)
    photo_ion: PhotoIonizationData | None = None

    # two-photon decay transitions (None when the dataset has none)
    two_photon: TwoPhotonData | None = None

    # tabulated collision strengths (None when the dataset has no
    # collision_data table; the continuum plasma then takes van Regemorter
    # rates for every collisional transition)
    collision: CollisionData | None = None

    # filled by prepare()
    species_z: np.ndarray | None = None  # (S,) unique species (Z, ion)
    species_ion: np.ndarray | None = None
    level_species_id: np.ndarray | None = None  # (N,) int32
    macro_atom: MacroAtomData | None = None
    downbranch: MacroAtomData | None = None
    zeta_data: dict | None = None  # {(Z, ion): (t_rads, zeta values)}

    # ------------------------------------------------------------------
    @property
    def n_levels(self) -> int:
        return len(self.level_energy)

    @property
    def n_lines(self) -> int:
        return len(self.line_nu)

    @property
    def line_wavelength_cm(self) -> np.ndarray:
        return C / self.line_nu

    def select_atoms(self, atomic_numbers) -> "AtomData":
        """Return a copy restricted to the given elements.

        Mirrors the species selection in the reference's
        ``AtomData.prepare_atom_data``
        (tardis/io/atom_data/base.py:397-541).
        """
        wanted = np.asarray(sorted(set(int(z) for z in atomic_numbers)))
        emask = np.isin(self.atomic_numbers, wanted)
        lmask = np.isin(self.level_z, wanted)
        imask = np.isin(self.ionization_z, wanted)

        # remap flat level indices for lines
        old_to_new = -np.ones(self.n_levels, dtype=np.int64)
        old_to_new[lmask] = np.arange(int(lmask.sum()))
        line_mask = np.isin(self.line_z, wanted)

        photo_ion = None
        if self.photo_ion is not None:
            pi = self.photo_ion
            keep = np.nonzero(np.isin(pi.cont_z, wanted))[0]
            refs = pi.block_references
            pts = np.concatenate(
                [np.arange(refs[c], refs[c + 1]) for c in keep]
            ) if len(keep) else np.zeros(0, dtype=np.int64)
            new_refs = np.zeros(len(keep) + 1, dtype=np.int32)
            np.cumsum([refs[c + 1] - refs[c] for c in keep],
                      out=new_refs[1:])
            photo_ion = PhotoIonizationData(
                cont_z=pi.cont_z[keep],
                cont_ion=pi.cont_ion[keep],
                cont_level=pi.cont_level[keep],
                level_flat_idx=old_to_new[pi.level_flat_idx[keep]].astype(
                    np.int32),
                block_references=new_refs,
                nu=pi.nu[pts],
                x_sect=pi.x_sect[pts],
            )

        two_photon = None
        if self.two_photon is not None:
            tp = self.two_photon
            keep_tp = np.isin(tp.z, wanted)
            if keep_tp.any():
                two_photon = TwoPhotonData(**{
                    f.name: getattr(tp, f.name)[keep_tp]
                    for f in dataclasses.fields(TwoPhotonData)})

        collision = None
        if self.collision is not None:
            co = self.collision
            keep_c = np.isin(self.level_z[co.lower_flat], wanted)
            collision = CollisionData(
                lower_flat=old_to_new[co.lower_flat[keep_c]].astype(np.int32),
                upper_flat=old_to_new[co.upper_flat[keep_c]].astype(np.int32),
                temperatures=co.temperatures,
                yg=co.yg[keep_c],
            )

        return AtomData(
            atomic_numbers=self.atomic_numbers[emask],
            masses=self.masses[emask],
            ionization_z=self.ionization_z[imask],
            ionization_ion=self.ionization_ion[imask],
            ionization_energy=self.ionization_energy[imask],
            level_z=self.level_z[lmask],
            level_ion=self.level_ion[lmask],
            level_number=self.level_number[lmask],
            level_energy=self.level_energy[lmask],
            level_g=self.level_g[lmask],
            level_meta=self.level_meta[lmask],
            line_nu=self.line_nu[line_mask],
            line_f_lu=self.line_f_lu[line_mask],
            line_lower_idx=old_to_new[self.line_lower_idx[line_mask]].astype(
                np.int32
            ),
            line_upper_idx=old_to_new[self.line_upper_idx[line_mask]].astype(
                np.int32
            ),
            line_z=self.line_z[line_mask],
            line_ion=self.line_ion[line_mask],
            meta=dict(self.meta),
            photo_ion=photo_ion,
            two_photon=two_photon,
            collision=collision,
            zeta_data=self.zeta_data,
        )

    # ------------------------------------------------------------------
    def prepare(self, selected_atoms=None, line_interaction_type="scatter"):
        """Select species, build species ids and macro-atom tables."""
        atom = self.select_atoms(selected_atoms) if selected_atoms else self
        # species ids
        pairs = np.stack([atom.level_z, atom.level_ion], axis=1)
        uniq, species_id = np.unique(pairs, axis=0, return_inverse=True)
        atom.species_z = uniq[:, 0]
        atom.species_ion = uniq[:, 1]
        atom.level_species_id = species_id.astype(np.int32)

        if line_interaction_type in ("downbranch", "macroatom"):
            atom.macro_atom = build_macro_atom(atom, downbranch=False)
            atom.downbranch = build_macro_atom(atom, downbranch=True)
        return atom


def build_macro_atom(atom: AtomData, downbranch: bool = False) -> MacroAtomData:
    """Construct macro-atom transition tables from the line list.

    Probability coefficients per
    docs/physics_walkthrough/setup/plasma/macroatom.rst:

    - emission down  (type -1): 2 nu^2/c^2 * (g_l/g_u) * f_lu * (eps_u - eps_l)
    - internal down  (type  0): 2 nu^2/c^2 * (g_l/g_u) * f_lu * eps_l
    - internal up    (type  1): f_lu / (h nu) * eps_i   (i = lower level)

    For ``downbranch`` only the emission transitions are kept (the reference
    implements downbranch as a macro atom restricted to emission,
    tardis/opacities/macro_atom/base.py:48-90).
    """
    # macro levels = all levels that participate in any line
    participating = np.zeros(atom.n_levels, dtype=bool)
    participating[atom.line_lower_idx] = True
    participating[atom.line_upper_idx] = True
    macro_level_of_flat = -np.ones(atom.n_levels, dtype=np.int64)
    macro_flat_ids = np.nonzero(participating)[0]
    macro_level_of_flat[macro_flat_ids] = np.arange(len(macro_flat_ids))
    n_macro = len(macro_flat_ids)

    eps_l = atom.level_energy[atom.line_lower_idx]
    eps_u = atom.level_energy[atom.line_upper_idx]
    g_l = atom.level_g[atom.line_lower_idx]
    g_u = atom.level_g[atom.line_upper_idx]
    nu = atom.line_nu
    f_lu = atom.line_f_lu
    L = atom.n_lines

    down_coef_base = 2.0 * nu**2 / C**2 * (g_l / g_u) * f_lu
    entries = []  # (macro_source, type, coef, dest_macro, line_id)

    # emission down: source = upper level
    entries.append(
        (
            macro_level_of_flat[atom.line_upper_idx],
            np.full(L, MACRO_EMISSION, dtype=np.int8),
            down_coef_base * (eps_u - eps_l),
            np.full(L, -1, dtype=np.int64),
            np.arange(L, dtype=np.int64),
        )
    )
    if not downbranch:
        # internal down: source = upper, dest = lower
        entries.append(
            (
                macro_level_of_flat[atom.line_upper_idx],
                np.full(L, MACRO_INTERNAL_DOWN, dtype=np.int8),
                down_coef_base * eps_l,
                macro_level_of_flat[atom.line_lower_idx],
                np.arange(L, dtype=np.int64),
            )
        )
        # internal up: source = lower, dest = upper
        entries.append(
            (
                macro_level_of_flat[atom.line_lower_idx],
                np.full(L, MACRO_INTERNAL_UP, dtype=np.int8),
                f_lu / (H * nu) * eps_l,
                macro_level_of_flat[atom.line_upper_idx],
                np.arange(L, dtype=np.int64),
            )
        )

    src = np.concatenate([e[0] for e in entries])
    ttype = np.concatenate([e[1] for e in entries])
    coef = np.concatenate([e[2] for e in entries])
    dest = np.concatenate([e[3] for e in entries])
    line_id = np.concatenate([e[4] for e in entries])

    # sort by (source level, type desc so up-block order is stable)
    order = np.lexsort((line_id, ttype, src))
    src, ttype, coef, dest, line_id = (
        src[order],
        ttype[order],
        coef[order],
        dest[order],
        line_id[order],
    )
    block_references = np.searchsorted(src, np.arange(n_macro + 1)).astype(
        np.int32
    )

    return MacroAtomData(
        coef=coef.astype(np.float64),
        transition_type=ttype,
        destination_level_id=dest.astype(np.int32),
        transition_line_id=line_id.astype(np.int32),
        block_references=block_references,
        line2macro_level_upper=macro_level_of_flat[atom.line_upper_idx].astype(
            np.int32
        ),
        macro_flat_ids=macro_flat_ids.astype(np.int32),
    )
