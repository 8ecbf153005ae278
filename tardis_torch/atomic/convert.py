"""Atomic data as a flat dict of numpy arrays, and back.

``atom_data_to_arrays`` flattens any prepared AtomData-shaped object (the
port's, or the JAX package's, which has the same fields) into
``{name: np.ndarray}``; ``atom_data_from_arrays`` rebuilds the port's
``AtomData`` from such a dict.  Both packages then compute on identical
inputs.  Keys: the AtomData array fields by name; the macro-atom,
downbranch, photoionization, two-photon and collision-strength tables as
``<table>/<field>`` (``macro_atom``, ``downbranch``, ``photo_ion``,
``two_photon``, ``collision``); the nebular zeta tables as
``zeta_data/<Z>/<ion>/t_rads`` and ``.../zeta``; and the carsus tables a
loaded file keeps in ``meta`` (``linelist_atoms``, ``linelist_molecules``,
``decay_radiation_data``: pandas frames; ``molecule_data``: a dict of
them) as ``meta/<name>``, each a copy of the object.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tardis_torch.atomic.atom_data import (
    AtomData,
    CollisionData,
    MacroAtomData,
    PhotoIonizationData,
    TwoPhotonData,
)

_TABLES = {"macro_atom": MacroAtomData, "downbranch": MacroAtomData,
           "photo_ion": PhotoIonizationData, "two_photon": TwoPhotonData,
           "collision": CollisionData}
# the carsus tables of ``meta`` that are carried across
META_TABLES = ("linelist_atoms", "linelist_molecules", "decay_radiation_data",
               "molecule_data")


def _array_fields(cls):
    skip = {"meta", "zeta_data", *_TABLES}
    return [f.name for f in dataclasses.fields(cls) if f.name not in skip]


def atom_data_to_arrays(atom) -> dict[str, np.ndarray]:
    out = {}
    for name in _array_fields(AtomData):
        v = getattr(atom, name)
        if v is not None:
            out[name] = np.asarray(v).copy()
    for table, cls in _TABLES.items():
        m = getattr(atom, table, None)
        if m is None:
            continue
        for f in dataclasses.fields(cls):
            v = getattr(m, f.name)
            if v is not None:
                out[f"{table}/{f.name}"] = np.asarray(v).copy()
    for (z, ion), (t_rads, zeta) in (atom.zeta_data or {}).items():
        out[f"zeta_data/{z}/{ion}/t_rads"] = np.asarray(t_rads).copy()
        out[f"zeta_data/{z}/{ion}/zeta"] = np.asarray(zeta).copy()
    for name in META_TABLES:
        v = (atom.meta or {}).get(name)
        if v is not None:
            out[f"meta/{name}"] = _copy_table(v)
    return out


def _copy_table(v):
    if isinstance(v, dict):
        return {k: _copy_table(x) for k, x in v.items()}
    return v.copy()


def atom_data_from_arrays(arrays: dict[str, np.ndarray]) -> AtomData:
    top = {k: np.asarray(v) for k, v in arrays.items() if "/" not in k}
    missing = [n for n in _array_fields(AtomData)
               if n not in top and n not in ("species_z", "species_ion",
                                             "level_species_id")]
    if missing:
        raise KeyError(f"atom data arrays lack {missing}")
    kw = dict(top)
    for table, cls in _TABLES.items():
        prefix = table + "/"
        fields = {k[len(prefix):]: np.asarray(v)
                  for k, v in arrays.items() if k.startswith(prefix)}
        kw[table] = cls(**fields) if fields else None
    zeta = {}
    for k, v in arrays.items():
        if k.startswith("zeta_data/") and k.endswith("/t_rads"):
            _, z, ion, _ = k.split("/")
            zeta[(int(z), int(ion))] = (
                np.asarray(v), np.asarray(arrays[k[:-len("t_rads")] + "zeta"])
            )
    kw["zeta_data"] = zeta or None
    kw["meta"] = {name: _copy_table(arrays[f"meta/{name}"])
                  for name in META_TABLES if f"meta/{name}" in arrays}
    return AtomData(**kw)
