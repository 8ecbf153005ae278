"""The port's ``atomic/download.py`` against the JAX package's.

Each case runs through both modules and compares their outcomes.  Every
file is written by the test under ``tmp_path`` with
``TARDIS_TPU_DATA_DIR`` pointed there; the only URLs fetched are
``file://`` URLs of those files and a refused port on 127.0.0.1, so no
case leaves this machine.
"""

import hashlib

import pytest
import torch

from tardis_torch.atomic import download as port_dl
from tardis_tpu.atomic import download as jax_dl

torch.set_num_threads(2)

MODULES = pytest.mark.parametrize("dl", [port_dl, jax_dl],
                                  ids=["port", "jax"])
NAME = "kurucz_cd23_chianti_H_He_latest"


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    d = tmp_path / "data"
    monkeypatch.setenv("TARDIS_TPU_DATA_DIR", str(d))
    return d


def _register(dl, monkeypatch, content, url=None):
    """Give NAME's registry entry the MD5 of ``content`` (and ``url``)."""
    entry = dict(dl.ATOMIC_DATA_REPO[NAME])
    entry["md5"] = hashlib.md5(content).hexdigest()
    if url is not None:
        entry["url"] = url
    monkeypatch.setitem(dl.ATOMIC_DATA_REPO, NAME, entry)


def _refuse_network(dl, monkeypatch):
    def fail(url, dst, timeout=60.0):
        raise AssertionError(f"download attempted from {url}")

    monkeypatch.setattr(dl, "_download_from_url", fail)


def test_same_registry():
    """Both packages name the same datasets, URLs and checksums."""
    assert port_dl.ATOMIC_DATA_REPO == jax_dl.ATOMIC_DATA_REPO


@MODULES
def test_unknown_name_refused(dl, data_dir):
    with pytest.raises(ValueError, match="not known"):
        dl.download_atom_data("no_such_dataset")


@MODULES
def test_staged_file_is_returned(dl, data_dir, monkeypatch):
    """A file staged by hand with a matching MD5 is returned as it is,
    without a download, under the default name too."""
    content = b"staged atomic data"
    _register(dl, monkeypatch, content)
    data_dir.mkdir(parents=True)
    staged = data_dir / f"{NAME}.h5"
    staged.write_bytes(content)
    _refuse_network(dl, monkeypatch)
    assert dl.download_atom_data(NAME) == staged
    assert dl.download_atom_data() == staged
    assert staged.read_bytes() == content


@MODULES
def test_corrupt_cache_is_fetched_again(dl, data_dir, monkeypatch):
    """A cached file failing its MD5 is fetched again, not returned."""
    fresh = b"fresh"
    _register(dl, monkeypatch, fresh)
    data_dir.mkdir(parents=True)
    (data_dir / f"{NAME}.h5").write_bytes(b"corrupt")
    calls = []

    def fake(url, path, timeout=60.0):
        calls.append(url)
        path.write_bytes(fresh)

    monkeypatch.setattr(dl, "_download_from_url", fake)
    out = dl.download_atom_data(NAME)
    assert calls == [dl.ATOMIC_DATA_REPO[NAME]["url"]]
    assert out.read_bytes() == fresh


@MODULES
def test_file_url_download(dl, data_dir, tmp_path, monkeypatch):
    """The real ``_download_from_url`` through a ``file://`` URL: the same
    bytes land at the dataset's path, force_download fetches again over a
    good cache, and no ``.part`` file is left behind."""
    content = bytes(range(256)) * 4099  # more than one 1 MiB block
    src = tmp_path / "mirror.h5"
    src.write_bytes(content)
    _register(dl, monkeypatch, content, url=src.as_uri())
    out = dl.download_atom_data(NAME)
    assert out == data_dir / f"{NAME}.h5"
    assert out.read_bytes() == content
    assert dl.download_atom_data(NAME, force_download=True).read_bytes() \
        == content
    assert not list(data_dir.glob("*.part"))


@MODULES
def test_mismatch_after_download_deletes(dl, data_dir, tmp_path,
                                         monkeypatch):
    """A download whose MD5 does not match raises and removes the file."""
    src = tmp_path / "mirror.h5"
    src.write_bytes(b"not what the registry says")
    _register(dl, monkeypatch, b"expected", url=src.as_uri())
    with pytest.raises(RuntimeError, match="MD5 mismatch"):
        dl.download_atom_data(NAME)
    assert not (data_dir / f"{NAME}.h5").exists()
    assert not list(data_dir.glob("*.part"))


@MODULES
def test_refused_connection_gives_air_gap_message(dl, data_dir,
                                                   monkeypatch):
    """Every URL failing (a refused local port, then a missing file as
    mirror) gives the message that says how to stage the file."""
    monkeypatch.setitem(dl.ATOMIC_DATA_REPO, "broken", {
        "url": "http://127.0.0.1:1/none.h5",
        "mirrors": ((data_dir / "absent.h5").as_uri(),), "md5": ""})
    with pytest.raises(RuntimeError, match="copy the file manually") as err:
        dl.download_atom_data("broken")
    assert str(data_dir / "broken.h5") in str(err.value)


def test_data_dir_and_checksum_agree(tmp_path, monkeypatch):
    """Both packages resolve the same data directory (set and default) and
    the same MD5, for a file larger than one chunk and with a small
    chunk."""
    monkeypatch.setenv("TARDIS_TPU_DATA_DIR", str(tmp_path / "set"))
    assert port_dl.get_data_dir() == jax_dl.get_data_dir() \
        == tmp_path / "set"
    assert (tmp_path / "set").is_dir()
    monkeypatch.delenv("TARDIS_TPU_DATA_DIR")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert port_dl.get_data_dir() == jax_dl.get_data_dir() \
        == tmp_path / "home" / ".tardis-tpu" / "data"
    path = tmp_path / "big.bin"
    content = bytes(range(251)) * 5000  # 1,255,000 bytes > 1 MiB
    path.write_bytes(content)
    want = hashlib.md5(content).hexdigest()
    assert port_dl.md5_checksum(path) == jax_dl.md5_checksum(path) == want
    assert port_dl.md5_checksum(path, chunk=1000) == \
        jax_dl.md5_checksum(path, chunk=1000) == want
