"""Atomic-data download / cache management.

Counterpart of ``tardis_tpu/atomic/download.py`` (the reference's
``download_atom_data``, tardis/io/atom_data/atom_web_download.py): resolve
a dataset name in the registry, place the ``.h5`` under the local data
directory, and verify its MD5.  The network is tried only when the file is
missing or corrupt, through urllib imported inside ``_download_from_url``;
a failure says how to stage the file by hand on a machine without network
egress.

Data dir resolution: ``$TARDIS_TPU_DATA_DIR`` if set, else
``~/.tardis-tpu/data`` -- the JAX package's, so one staged file serves
both packages.  Host only: no torch, no device.
"""

from __future__ import annotations

import hashlib
import logging
import os
from pathlib import Path

logger = logging.getLogger(__name__)

# the registry of the reference's tardis/data/atomic_data_repo.yml
ATOMIC_DATA_REPO = {
    "default": "kurucz_cd23_chianti_H_He_latest",
    "kurucz_cd23_chianti_H_He_latest": {
        "url": (
            "https://media.githubusercontent.com/media/tardis-sn/"
            "tardis-regression-data/main/atom_data/"
            "kurucz_cd23_chianti_H_He_latest.h5"
        ),
        "mirrors": (),
        "md5": "16341df5d104b462be4c3e51b167a893",
    },
}


def get_data_dir() -> Path:
    data_dir = Path(
        os.environ.get(
            "TARDIS_TPU_DATA_DIR", Path.home() / ".tardis-tpu" / "data"
        )
    )
    data_dir.mkdir(parents=True, exist_ok=True)
    return data_dir


def md5_checksum(path, chunk=1 << 20) -> str:
    digest = hashlib.md5()
    with open(path, "rb") as f:
        while block := f.read(chunk):
            digest.update(block)
    return digest.hexdigest()


def download_atom_data(atomic_data_name: str | None = None,
                       force_download: bool = False) -> Path:
    """Fetch (or locate) a named atomic dataset; returns the local path.

    A file already there with a matching checksum is reused.  On a machine
    without network egress, stage the file by hand at the returned path;
    the error message spells this out.
    """
    if atomic_data_name is None:
        atomic_data_name = ATOMIC_DATA_REPO["default"]
    if atomic_data_name not in ATOMIC_DATA_REPO:
        raise ValueError(f"Atomic Data name {atomic_data_name} not known")
    entry = ATOMIC_DATA_REPO[atomic_data_name]
    dst = get_data_dir() / f"{atomic_data_name}.h5"

    if dst.exists() and not force_download:
        if entry.get("md5") and md5_checksum(dst) != entry["md5"]:
            # a corrupt cache is fetched again (the reference deletes and
            # re-fetches on a mismatch), never returned
            logger.warning(
                "%s exists but fails its MD5 check; re-downloading", dst
            )
        else:
            logger.info("Atomic data %s already cached at %s",
                        atomic_data_name, dst)
            return dst

    urls = (entry["url"], *entry.get("mirrors", ()))
    last_error = None
    for url in urls:
        try:
            logger.info("Downloading atomic data from %s to %s", url, dst)
            _download_from_url(url, dst)
            break
        except Exception as exc:  # noqa: BLE001 - report all failures below
            last_error = exc
            logger.warning("download from %s failed: %s", url, exc)
    else:
        raise RuntimeError(
            f"Could not download {atomic_data_name} "
            f"(last error: {last_error}). If this machine has no network "
            f"egress, copy the file manually to {dst} and re-run."
        )

    if entry.get("md5"):
        actual = md5_checksum(dst)
        if actual != entry["md5"]:
            dst.unlink(missing_ok=True)
            raise RuntimeError(
                f"MD5 mismatch for {atomic_data_name}: expected "
                f"{entry['md5']}, got {actual}"
            )
    return dst


def _download_from_url(url: str, dst: Path, timeout: float = 60.0):
    """Stream ``url`` into ``dst.part``, then replace ``dst`` with it."""
    import urllib.request

    tmp = dst.with_suffix(".part")
    with urllib.request.urlopen(url, timeout=timeout) as resp, \
            open(tmp, "wb") as out:
        while block := resp.read(1 << 20):
            out.write(block)
    tmp.replace(dst)
