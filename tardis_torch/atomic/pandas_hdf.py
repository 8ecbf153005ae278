"""h5py decoder for pandas-written HDF5 stores.

Carsus atomic-data files (kurucz_cd23_chianti...) are written with
``pandas.HDFStore`` and normally require PyTables to read.  Where PyTables
is not installed this module reconstructs pandas DataFrames/Series
directly from the on-disk layout with h5py:

- *fixed* format ("pandas_type" = frame/series): ``axis0``/``axis1`` axes
  (regular or MultiIndex as ``axisN_levelK``/``axisN_labelK``) plus
  ``block{i}_items``/``block{i}_values`` data blocks;
- *table* format: a single ``table`` dataset with a compound dtype whose
  fields are ``index``/column names (plus ``values_block_N`` groups
  described by the ``*_kind`` attributes).

Reference behavior mirrored: ``AtomData.from_hdf``
(tardis/io/atom_data/base.py:178-330) reads these stores with pandas; the
same DataFrames come out here.  The port's copy of
``tardis_tpu/atomic/pandas_hdf.py``; pandas and h5py are imported inside
the functions, so the rest of the port never needs them.
"""

from __future__ import annotations

import numpy as np


def _attr(obj, name, default=None):
    val = obj.attrs.get(name, default)
    if isinstance(val, np.void):
        val = _maybe_unpickle(val)
    if isinstance(val, bytes):
        val = val.decode()
    return val


def _decode_1d(values):
    values = np.asarray(values)
    if values.dtype.kind in ("S", "O"):
        return np.array(
            [v.decode() if isinstance(v, bytes) else v for v in values],
            dtype=object,
        )
    return values


def _read_index(group, axis: str):
    """Read a (possibly Multi-) index stored under `axis` in a fixed-format
    pandas group."""
    import pandas as pd

    variety = _attr(group, f"{axis}_variety", "regular")
    if variety == "multi":
        nlevels = int(group.attrs[f"{axis}_nlevels"])
        levels, codes, names = [], [], []
        for k in range(nlevels):
            lvl_ds = group[f"{axis}_level{k}"]
            levels.append(_decode_1d(lvl_ds[()]))
            names.append(_attr(lvl_ds, "name"))
            codes.append(np.asarray(group[f"{axis}_label{k}"][()]))
        return pd.MultiIndex(
            levels=[pd.Index(l) for l in levels], codes=codes, names=names
        )
    ds = group[axis]
    idx = pd.Index(_decode_1d(ds[()]))
    name = _attr(ds, "name")
    if name is not None:
        idx.name = name
    # pandas stores datetime indexes as i8 with a 'kind' attribute
    if _attr(ds, "kind") in ("datetime64", "datetime"):
        idx = pd.to_datetime(idx)
    return idx


def _read_fixed_frame(group):
    import pandas as pd

    columns = _read_index(group, "axis0")
    index = _read_index(group, "axis1")
    nblocks = int(group.attrs.get("nblocks", 1))
    data = {}
    for b in range(nblocks):
        items = _read_index(group, f"block{b}_items")
        values = np.asarray(group[f"block{b}_values"][()])
        if values.ndim == 1:
            values = values.reshape(1, -1)
        # pandas blocks are (n_items, n_rows); tolerate the transpose
        if values.shape[0] != len(items) and values.shape[1] == len(items):
            values = values.T
        for j, item in enumerate(items):
            col = _decode_1d(values[j])
            data[item] = col
    df = pd.DataFrame(data, index=index)
    # restore original column order
    df = df[[c for c in columns if c in df.columns]]
    return df


def _read_fixed_series(group):
    import pandas as pd

    index = _read_index(group, "index")
    values = _decode_1d(group["values"][()])
    name = _attr(group, "name")
    return pd.Series(values, index=index, name=name)


def _maybe_unpickle(val):
    """PyTables stores Python-object attrs (lists, tuples) as pickled bytes
    (h5py surfaces opaque attrs as np.void)."""
    if isinstance(val, np.void):
        val = val.tobytes()
    if isinstance(val, bytes):
        try:
            import pickle

            return pickle.loads(val)
        except Exception:
            return val.decode(errors="replace")
    return val


def _as_str(v):
    return v.decode() if isinstance(v, bytes) else v


def _read_table_frame(group):
    """Decode pandas 'table' format: one structured-dtype dataset.

    Column names of multi-column ``values_block_N`` fields come from the
    pickled ``{name}_kind`` attribute on the table dataset (``{name}_meta``
    holds a meta string like 'category', NOT the names); index fields are
    identified from the pickled ``index_cols`` metadata (``[(axis, name)]``)
    so table-format MultiIndex frames (fields named by level names) restore
    their index correctly.
    """
    import pandas as pd

    ds = group["table"]
    table = ds[()]
    names = table.dtype.names

    # --- which fields form the (Multi)Index ---
    index_fields = []
    idx_attr = _maybe_unpickle(ds.attrs.get("index_cols", None))
    if isinstance(idx_attr, (list, tuple)):
        for entry in idx_attr:
            nm = entry[1] if isinstance(entry, (tuple, list)) else entry
            nm = _as_str(nm)
            if nm in names:
                index_fields.append(nm)
    if not index_fields:  # layout probing fallback
        index_fields = [
            n for n in names if n == "index" or n.startswith("index_")
        ]

    data = {}
    order = []
    for name in names:
        col = table[name]
        is_block = name.startswith("values_block")
        if is_block:
            kind = _maybe_unpickle(ds.attrs.get(f"{name}_kind", None))
            if isinstance(kind, (list, tuple, np.ndarray)):
                labels = [_as_str(k) for k in kind]
            else:
                labels = None
            if col.ndim == 1:
                col = col[:, None]
            nsub = col.shape[1]
            if labels is None or len(labels) != nsub:
                labels = (
                    [name]
                    if nsub == 1
                    else [f"{name}_{j}" for j in range(nsub)]
                )
            for j in range(nsub):
                data[labels[j]] = _decode_1d(col[:, j])
                order.append(labels[j])
            continue
        if col.ndim == 2 and col.shape[1] == 1:
            col = col[:, 0]
        data[name] = _decode_1d(col)
        order.append(name)
    df = pd.DataFrame(data)
    if index_fields:
        df = df.set_index(index_fields)
        if index_fields == ["index"]:
            df.index.name = None
    return df


def read_pandas_hdf(path: str, key: str):
    """Read one pandas object (frame or series) from a pandas-HDF file."""
    import h5py

    with h5py.File(path, "r") as f:
        if not key.startswith("/"):
            key = "/" + key
        if key not in f:
            raise KeyError(f"{key} not in {path}")
        group = f[key]
        pandas_type = _attr(group, "pandas_type", "")
        if "table" in group:
            return _read_table_frame(group)
        if pandas_type.startswith("series"):
            return _read_fixed_series(group)
        return _read_fixed_frame(group)


def list_keys(path: str) -> list[str]:
    """Top-level pandas object keys in the file."""
    import h5py

    keys = []
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Group) and "pandas_type" in obj.attrs:
                keys.append("/" + name)
        f.visititems(visit)
    return keys


class H5PandasStore:
    """Minimal pandas.HDFStore-compatible reader backed by h5py."""

    def __init__(self, path: str):
        self.path = path
        self._keys = set(list_keys(path))

    def __contains__(self, key):
        if not key.startswith("/"):
            key = "/" + key
        return key in self._keys

    def __getitem__(self, key):
        return read_pandas_hdf(self.path, key)

    def keys(self):
        return sorted(self._keys)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def open_store(path: str):
    """Open `path` with pandas.HDFStore when PyTables is available,
    otherwise with the h5py fallback decoder."""
    import pandas as pd

    try:
        import tables  # noqa: F401

        return pd.HDFStore(path, "r")
    except ImportError:
        return H5PandasStore(path)
