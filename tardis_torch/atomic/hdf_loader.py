"""Loader for carsus-format atomic data HDF files (kurucz_cd23_chianti...).

Mirrors the columns and unit conventions of the reference's
``AtomData.from_hdf`` (tardis/io/atom_data/base.py:178-330): level energies
and ionization energies are stored in eV and converted to erg; lines carry
nu [Hz], f_lu, and (Z, ion, level_number_lower/upper).

The port's copy of ``tardis_tpu/atomic/hdf_loader.py``, call for call
where the order of rows depends on it (the lines come from pandas'
``sort_values("nu", ascending=False)``, whose default sort is not
stable: another sort would order lines of equal frequency otherwise and
part the two packages' line lists).  ``write_atom_data_hdf`` writes an
AtomData in the same layout, for files made at run time.  pandas and h5py
are imported inside the functions, so the rest of the port never needs
them.
"""

from __future__ import annotations

import numpy as np

from tardis_torch.atomic.atom_data import (
    AtomData,
    CollisionData,
    PhotoIonizationData,
    TwoPhotonData,
)
from tardis_torch.constants import M_U

EV_TO_ERG = 1.602176634e-12


def atom_data_from_hdf(path: str) -> AtomData:
    """Read a carsus atomic-data HDF file into the flat AtomData layout.

    Uses pandas.HDFStore when PyTables is installed, else the h5py-based
    decoder in :mod:`tardis_torch.atomic.pandas_hdf`.
    """
    from tardis_torch.atomic.pandas_hdf import open_store

    with open_store(path) as store:
        atom_df = store["atom_data"]
        ionization = store["ionization_data"]
        levels = store["levels_data"] if "levels_data" in store else store["levels"]
        lines = store["lines_data"] if "lines_data" in store else store["lines"]
        zeta = store["zeta_data"] if "zeta_data" in store else None
        coll = (
            store["collision_data"] if "collision_data" in store else None
        )
        coll_t = (
            store["collision_data_temperatures"]
            if "collision_data_temperatures" in store
            else None
        )
        pion = (
            store["photoionization_data"]
            if "photoionization_data" in store
            else None
        )
        two_ph = (
            store["two_photon_data"] if "two_photon_data" in store else None
        )
        # load-only tables the reference also just carries
        # (io/atom_data/base.py:97-131): kept in meta for downstream use
        extra = {}
        for name in (
            "linelist_atoms",
            "linelist_molecules",
            # per-isotope gamma-line/positron tables for the high-energy
            # vertical (reference decay_radiation.py consumes this table;
            # energy_input/decay.py decay_radiation_from_atom_data parses
            # it into IsotopeRadiation entries)
            "decay_radiation_data",
        ):
            if name in store:
                extra[name] = store[name]
        # molecular thermochemistry tables (reference MoleculeData,
        # io/atom_data/base.py:111-135 + from_hdf:239-246): loaded and
        # exposed exactly as the reference does — the reference core also
        # only carries them (no plasma/transport consumer exists there
        # either), so load-and-expose IS full parity
        if "molecules/equilibrium_constants" in store:
            extra["molecule_data"] = {
                "equilibrium_constants": store[
                    "molecules/equilibrium_constants"
                ],
                "partition_functions": store[
                    "molecules/partition_functions"
                ],
                "dissociation_energies": store[
                    "molecules/dissociation_energies"
                ],
            }

    # --- elements
    atom_df = atom_df.reset_index()
    atomic_numbers = atom_df["atomic_number"].to_numpy(dtype=np.int64)
    masses = atom_df["mass"].to_numpy(dtype=np.float64) * M_U

    # --- ionization (index (atomic_number, ion_number), eV)
    ion = ionization.reset_index()
    ion_energy_col = (
        "ionization_energy" if "ionization_energy" in ion.columns else ion.columns[-1]
    )

    # --- levels
    lv = levels.reset_index().sort_values(
        ["atomic_number", "ion_number", "level_number"]
    )
    level_z = lv["atomic_number"].to_numpy(np.int64)
    level_ion = lv["ion_number"].to_numpy(np.int64)
    level_number = lv["level_number"].to_numpy(np.int64)
    level_energy = lv["energy"].to_numpy(np.float64) * EV_TO_ERG
    level_g = lv["g"].to_numpy(np.float64)
    level_meta = lv["metastable"].to_numpy(bool)

    # flat index lookup for (Z, ion, level)
    key = (level_z.astype(np.int64) << 40) | (level_ion << 20) | level_number
    order = np.argsort(key)
    key_sorted = key[order]

    def flat_idx(z, i, n):
        k = (z.astype(np.int64) << 40) | (i.astype(np.int64) << 20) | n.astype(
            np.int64
        )
        pos = np.searchsorted(key_sorted, k)
        return order[pos].astype(np.int32)

    # --- lines, sorted by nu descending (reference line_list_nu order)
    ln = lines.reset_index()
    ln = ln.sort_values("nu", ascending=False)
    line_nu = ln["nu"].to_numpy(np.float64)
    line_f_lu = ln["f_lu"].to_numpy(np.float64)
    lz = ln["atomic_number"].to_numpy(np.int64)
    li = ln["ion_number"].to_numpy(np.int64)
    lower = flat_idx(lz, li, ln["level_number_lower"].to_numpy(np.int64))
    upper = flat_idx(lz, li, ln["level_number_upper"].to_numpy(np.int64))

    collision = None
    if coll is not None and coll_t is not None:
        cd = coll.reset_index()
        # value columns = one per tabulated temperature (YgData convention:
        # yg_data.columns = t_yg, plasma/properties/atomic.py:688-696)
        temps = np.asarray(coll_t.to_numpy(np.float64)).ravel()
        value_cols = [
            c
            for c in cd.columns
            if str(c)
            not in (
                "index",
                "atomic_number",
                "ion_number",
                "level_number_lower",
                "level_number_upper",
                "e_col_id",
                "delta_e",
                "gf",
                "ttype",
                "cups",
            )
            and np.issubdtype(cd[c].dtype, np.number)
        ][: len(temps)]
        yg = cd[value_cols].to_numpy(np.float64)
        cz = cd["atomic_number"].to_numpy(np.int64)
        ci = cd["ion_number"].to_numpy(np.int64)
        collision = CollisionData(
            lower_flat=flat_idx(
                cz, ci, cd["level_number_lower"].to_numpy(np.int64)
            ),
            upper_flat=flat_idx(
                cz, ci, cd["level_number_upper"].to_numpy(np.int64)
            ),
            temperatures=temps,
            yg=yg,
        )

    zeta_data = None
    if zeta is not None:
        zeta_data = {}
        t_rads = np.array([float(c) for c in zeta.columns])
        for (z, i), row in zeta.iterrows():
            zeta_data[(int(z), int(i))] = (t_rads, row.to_numpy(np.float64))

    # --- photoionization cross-sections -> CSR blocks, continua sorted by
    # threshold nu DESCENDING (reference level2continuum_idx ordering,
    # iip_plasma/properties/continuum.py:1448-1452)
    photo_ion = None
    if pion is not None:
        pf = pion.reset_index()
        pz = pf["atomic_number"].to_numpy(np.int64)
        pi_ = pf["ion_number"].to_numpy(np.int64)
        pl = pf["level_number"].to_numpy(np.int64)
        pnu = pf["nu"].to_numpy(np.float64)
        pxs = pf["x_sect"].to_numpy(np.float64)
        # group rows by (z, ion, level); rows within a block are the
        # ascending frequency grid of that continuum
        gkey = (pz << 40) | (pi_ << 20) | pl
        # stable order preserves each block's frequency grid ordering
        gorder = np.argsort(gkey, kind="stable")
        gk = gkey[gorder]
        starts = np.concatenate(
            [[0], np.nonzero(np.diff(gk))[0] + 1, [len(gk)]]
        )
        blocks = []
        for b in range(len(starts) - 1):
            rows = gorder[starts[b] : starts[b + 1]]
            nus = pnu[rows]
            srt = np.argsort(nus)
            rows = rows[srt]
            blocks.append(
                (pnu[rows[0]], pz[rows[0]], pi_[rows[0]], pl[rows[0]],
                 rows)
            )
        blocks.sort(key=lambda r: -r[0])  # threshold descending
        refs = np.zeros(len(blocks) + 1, np.int32)
        np.cumsum([len(b[4]) for b in blocks], out=refs[1:])
        photo_ion = PhotoIonizationData(
            cont_z=np.array([b[1] for b in blocks], np.int64),
            cont_ion=np.array([b[2] for b in blocks], np.int64),
            cont_level=np.array([b[3] for b in blocks], np.int64),
            level_flat_idx=flat_idx(
                np.array([b[1] for b in blocks], np.int64),
                np.array([b[2] for b in blocks], np.int64),
                np.array([b[3] for b in blocks], np.int64),
            ),
            block_references=refs,
            nu=np.concatenate([pnu[b[4]] for b in blocks]),
            x_sect=np.concatenate([pxs[b[4]] for b in blocks]),
        )

    # --- two-photon decay data (A_ul, nu0, NS84 alpha/beta/gamma)
    two_photon = None
    if two_ph is not None:
        tf = two_ph.reset_index()
        two_photon = TwoPhotonData(
            z=tf["atomic_number"].to_numpy(np.int64),
            ion=tf["ion_number"].to_numpy(np.int64),
            level_lower=tf["level_number_lower"].to_numpy(np.int64),
            level_upper=tf["level_number_upper"].to_numpy(np.int64),
            A_ul=tf["A_ul"].to_numpy(np.float64),
            nu0=tf["nu0"].to_numpy(np.float64),
            alpha=tf["alpha"].to_numpy(np.float64),
            beta=tf["beta"].to_numpy(np.float64),
            gamma=tf["gamma"].to_numpy(np.float64),
        )

    return AtomData(
        atomic_numbers=atomic_numbers,
        masses=masses,
        ionization_z=ion["atomic_number"].to_numpy(np.int64),
        ionization_ion=ion["ion_number"].to_numpy(np.int64),
        ionization_energy=ion[ion_energy_col].to_numpy(np.float64) * EV_TO_ERG,
        level_z=level_z,
        level_ion=level_ion,
        level_number=level_number,
        level_energy=level_energy,
        level_g=level_g,
        level_meta=level_meta,
        line_nu=line_nu,
        line_f_lu=line_f_lu,
        line_lower_idx=lower,
        line_upper_idx=upper,
        line_z=lz,
        line_ion=li,
        meta={"source": path, **extra},
        zeta_data=zeta_data,
        collision=collision,
        photo_ion=photo_ion,
        two_photon=two_photon,
    )


def write_atom_data_hdf(atom: AtomData, path: str) -> None:
    """Write ``atom`` (before ``prepare``) as a carsus-layout HDF file that
    ``atom_data_from_hdf`` reads back: energies in eV, masses in u, levels,
    lines, zeta, collision, photoionization and two-photon tables, and the
    pandas tables of ``meta`` (``linelist_*``, ``decay_radiation_data``,
    ``molecule_data``) under their carsus keys.  Written with the port's
    fixed-format writer, so h5py alone suffices (PyTables is not needed)."""
    import h5py
    import pandas as pd

    from tardis_torch.io.pandas_hdf_writer import write_frame, write_series

    frames = {
        "atom_data": pd.DataFrame({"atomic_number": atom.atomic_numbers,
                                   "mass": atom.masses / M_U}),
        "ionization_data": pd.DataFrame({
            "atomic_number": atom.ionization_z,
            "ion_number": atom.ionization_ion,
            "ionization_energy": atom.ionization_energy / EV_TO_ERG}),
        "levels_data": pd.DataFrame({
            "atomic_number": atom.level_z, "ion_number": atom.level_ion,
            "level_number": atom.level_number,
            "energy": atom.level_energy / EV_TO_ERG, "g": atom.level_g,
            "metastable": atom.level_meta}),
        "lines_data": pd.DataFrame({
            "atomic_number": atom.line_z, "ion_number": atom.line_ion,
            "level_number_lower": atom.level_number[atom.line_lower_idx],
            "level_number_upper": atom.level_number[atom.line_upper_idx],
            "nu": atom.line_nu, "f_lu": atom.line_f_lu}),
    }
    if atom.zeta_data:
        species = sorted(atom.zeta_data)
        t_rads = atom.zeta_data[species[0]][0]
        if any(not np.array_equal(atom.zeta_data[s][0], t_rads)
               for s in species):
            raise ValueError("zeta tables on different temperature grids")
        frames["zeta_data"] = pd.DataFrame(
            np.stack([atom.zeta_data[s][1] for s in species]),
            index=pd.MultiIndex.from_tuples(
                species, names=["atomic_number", "ion_number"]),
            columns=[float(t) for t in t_rads])
    co = atom.collision
    if co is not None:
        frames["collision_data"] = pd.DataFrame({
            "atomic_number": atom.level_z[co.lower_flat],
            "ion_number": atom.level_ion[co.lower_flat],
            "level_number_lower": atom.level_number[co.lower_flat],
            "level_number_upper": atom.level_number[co.upper_flat],
            **{f"t{k}": co.yg[:, k] for k in range(co.yg.shape[1])}})
    pi = atom.photo_ion
    if pi is not None:
        block = np.repeat(np.arange(pi.n_continua),
                          np.diff(pi.block_references))
        frames["photoionization_data"] = pd.DataFrame({
            "atomic_number": pi.cont_z[block],
            "ion_number": pi.cont_ion[block],
            "level_number": pi.cont_level[block], "nu": pi.nu,
            "x_sect": pi.x_sect})
    tp = atom.two_photon
    if tp is not None:
        frames["two_photon_data"] = pd.DataFrame({
            "atomic_number": tp.z, "ion_number": tp.ion,
            "level_number_lower": tp.level_lower,
            "level_number_upper": tp.level_upper, "A_ul": tp.A_ul,
            "nu0": tp.nu0, "alpha": tp.alpha, "beta": tp.beta,
            "gamma": tp.gamma})
    meta = atom.meta or {}
    for name in ("linelist_atoms", "linelist_molecules",
                 "decay_radiation_data"):
        if meta.get(name) is not None:
            frames[name] = meta[name]
    for name, df in (meta.get("molecule_data") or {}).items():
        frames[f"molecules/{name}"] = df
    with h5py.File(path, "w") as f:
        for key, df in frames.items():
            write_frame(f, "/" + key, df)
        if co is not None:
            write_series(f, "/collision_data_temperatures",
                         pd.Series(co.temperatures))
