"""Convert a raw CMFGEN model-output file to the TARDIS CMFGEN csv format.

Counterpart of the reference's ``cmfgen2tardis`` console entry point
(tardis/scripts/cmfgen2tardis.py:1-126, registered in
pyproject.toml:16-17).  The output file starts with a ``t0: <days> day``
header line followed by a two-row (name, unit) column header and the
space-separated table — the format read back by
:func:`tardis_torch.io.model_readers.read_cmfgen_model`.

Element symbols resolve through the built-in periodic table rather than an
atomic dataset (the reference needs ``AtomData`` only for this lookup).
The port's copy of ``tardis_tpu/io/cmfgen2tardis.py``; run it as
``python -m tardis_torch.io.cmfgen2tardis <cmfgen file> <output dir>``.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from tardis_torch.atomic.atom_data import ATOMIC_SYMBOLS

_PROPERTIES = ("Velocity", "Density", "Electron density", "Temperature")
_SYMBOLS_LOWER = {s.lower(): s for s in ATOMIC_SYMBOLS}


def _extract_block(f) -> np.ndarray:
    """Read whitespace-separated floats until a blank line; CMFGEN stores
    shells outermost-first, TARDIS innermost-first, so reverse."""
    values = []
    for line in f:
        items = line.split()
        if not items:
            break
        values.extend(float(x) for x in items)
    return np.asarray(values, dtype=np.float64)[::-1]


def parse_cmfgen_output(path: str):
    """Parse one CMFGEN file; returns (columns, units, abundances, t0_day).

    ``columns`` maps column name -> 1D array (innermost shell first);
    ``abundances`` maps element/isotope symbol -> mass-fraction array.
    """
    columns: dict[str, np.ndarray] = {}
    units: dict[str, str] = {}
    abundances: dict[str, np.ndarray] = {}
    t0_day = None
    with open(path) as f:
        for line in f:
            items = line.replace("(", "").replace(")", "").split()
            if not items:
                continue
            if "Time" in line and t0_day is None:
                t0_day = float(items[-1])
            for prop in _PROPERTIES:
                if prop in line:
                    key = prop.lower().replace(" ", "_")
                    units[key] = items[-1].replace("gm", "g")
                    columns[key] = _extract_block(f)
                    break
            else:
                if "mass fraction" in line:
                    symbol = _SYMBOLS_LOWER.get(items[0].strip().lower())
                    if symbol is None:
                        raise ValueError(
                            f"unknown element {items[0]!r} in {path}"
                        )
                    # isotope lines carry the mass number as a second token
                    if len(items) >= 4 and re.fullmatch(r"\d+", items[1]):
                        symbol += items[1]
                    abundances[symbol] = _extract_block(f)
    if t0_day is None or "velocity" not in columns:
        raise ValueError(f"{path} does not look like a CMFGEN model file")
    # CMFGEN temperature is in units of 10^4 K
    if "temperature" in columns:
        columns["temperature"] = columns["temperature"] * 1e4
        units["temperature"] = "K"
    return columns, units, abundances, t0_day


def convert_cmfgen_file(input_path: str, output_dir: str) -> str:
    """Convert `input_path`; writes `<stem>.csv` under `output_dir` and
    returns the output path."""
    columns, units, abundances, t0_day = parse_cmfgen_output(input_path)
    out = Path(output_dir) / (Path(input_path).stem + ".csv")

    names = ["velocity", "temperature", "densities", "electron_densities"]
    sources = ["velocity", "temperature", "density", "electron_density"]
    unit_row = [
        units.get("velocity", "km/s"),
        units.get("temperature", "K"),
        units.get("density", "g/cm^3"),
        units.get("electron_density", "/cm^3"),
    ]
    n = len(columns["velocity"])
    table = [columns.get(src, np.full(n, np.nan)) for src in sources]
    for symbol, frac in abundances.items():
        names.append(symbol)
        unit_row.append("1")
        table.append(frac)

    with open(out, "w") as f:
        f.write(f"t0: {t0_day} day\n")
        f.write("Index " + " ".join(names) + "\n")
        f.write("- " + " ".join(str(u) for u in unit_row) + "\n")
        for i, row in enumerate(np.stack(table, axis=1)):
            f.write(f"{i} " + " ".join(repr(float(v)) for v in row) + "\n")
    return str(out)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Convert a CMFGEN model file to TARDIS CMFGEN csv format"
    )
    ap.add_argument("input_path", help="Path to a CMFGEN file")
    ap.add_argument("output_path", help="Directory for the converted file")
    args = ap.parse_args(argv)
    path = convert_cmfgen_file(args.input_path, args.output_path)
    print(path)


if __name__ == "__main__":
    main()
