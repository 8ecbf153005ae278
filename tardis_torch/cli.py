"""Command-line interface.

Counterpart of the reference's ``tardis`` script
(tardis/scripts/tardis: argparse, config -> spectrum file) and the port's
copy of ``tardis_tpu/cli.py``: run a YAML config, write the spectrum as
ASCII and optionally the full HDF (``io/hdf.py``, which needs h5py).

    python -m tardis_torch.cli config.yml spectrum.dat [--device cpu]

The run goes to the card unless ``--device`` names another device, as
every entry point of the port does; without a card and without
``--device cpu`` it raises.  ``--log-level`` configures the
``tardis_torch`` logger through ``run_tardis``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="tardis-torch",
        description="supernova radiative transfer on a CUDA card (PyTorch)",
    )
    ap.add_argument("config", help="YAML configuration file")
    ap.add_argument("spectrum", nargs="?", default=None,
                    help="output spectrum file (ASCII: wavelength[AA] L_lambda)")
    ap.add_argument("--hdf", default=None, help="write full results HDF")
    ap.add_argument("--log-level", default="INFO")
    ap.add_argument(
        "--spectrum-kind",
        default="real",
        choices=["real", "virtual", "integrated"],
    )
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)

    from tardis_torch.simulation.base import run_tardis

    sim = run_tardis(args.config, device=args.device,
                     log_level=args.log_level)

    spec = {
        "real": sim.spectrum_real,
        "virtual": sim.spectrum_virtual,
        "integrated": (
            sim.spectrum_integrated
            or (sim.integrate_spectrum()
                if args.spectrum_kind == "integrated" else None)
        ),
    }[args.spectrum_kind]
    if spec is None:
        print(f"spectrum kind '{args.spectrum_kind}' not available",
              file=sys.stderr)
        return 1

    if args.spectrum:
        wl_aa = spec.wavelength * 1e8
        order = np.argsort(wl_aa)
        np.savetxt(
            args.spectrum,
            np.column_stack([wl_aa[order], spec.luminosity_lambda[order]]),
            header="wavelength[AA] luminosity_lambda[erg/s/cm]",
        )
    if args.hdf:
        from tardis_torch.io.hdf import simulation_to_hdf

        simulation_to_hdf(sim, args.hdf)
    return 0


if __name__ == "__main__":
    sys.exit(main())
