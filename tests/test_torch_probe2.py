"""The probe kernels' plain versions (``tardis_torch/benchmarks/probe2.py``)
against the Pallas kernels of ``tardis_tpu/benchmarks/probe2.py``.

The JAX kernels are nested inside its ``main()`` and cannot be imported, so
their one-line bodies are repeated here verbatim and run through
``pl.pallas_call(..., interpret=True)`` with the probe's whole-array VMEM
block specs, at the probe's shapes, on inputs drawn with numpy.  Both
sides are exact (a doubling and two gathers), so they must agree bit for
bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tardis_torch import cuda
from tardis_torch.benchmarks import probe2

torch.set_num_threads(2)


def kern(x_ref, o_ref):
    o_ref[:] = x_ref[:] * 2.0


def gkern(tab_ref, idx_ref, o_ref):
    o_ref[:] = jnp.take(tab_ref[:], idx_ref[:], axis=0)


def gkern2(tab_ref, idx_ref, o_ref):
    o_ref[:] = jnp.take_along_axis(tab_ref[:], idx_ref[:], axis=1)


def _pallas(body, out_shape, *args):
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    return np.asarray(pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        in_specs=[vmem] * len(args), out_specs=vmem, interpret=True,
    )(*args))


def test_scale2_matches_kern():
    """A 1 MB slice of the probe's VMEM round trip ((n, 128) f32; the probe
    runs 16-120 MB, the same kernel at other n)."""
    x = np.random.default_rng(1).uniform(-3.0, 3.0, (2048, 128)).astype(
        np.float32)
    ours = probe2.scale2(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(ours, _pallas(kern, x.shape, x))
    np.testing.assert_array_equal(ours, 2 * x)


def test_take_1d_matches_gkern():
    """The probe's shapes: a (4,096,) table and (1,024,) indices."""
    gen = np.random.default_rng(2)
    tab = gen.uniform(0.0, 1.0, 4096).astype(np.float32)
    idx = gen.integers(0, 4096, 1024).astype(np.int32)
    ours = probe2.take_1d(torch.as_tensor(tab), torch.as_tensor(idx))
    np.testing.assert_array_equal(ours.numpy(),
                                  _pallas(gkern, (1024,), tab, idx))


def test_take_along_rows_matches_gkern2():
    """The probe's shapes: (1,024, 128) rows and indices in [0, 128)."""
    gen = np.random.default_rng(3)
    tab = gen.uniform(0.0, 1.0, (1024, 128)).astype(np.float32)
    idx = gen.integers(0, 128, (1024, 128)).astype(np.int32)
    ours = probe2.take_along_rows(torch.as_tensor(tab), torch.as_tensor(idx))
    np.testing.assert_array_equal(ours.numpy(),
                                  _pallas(gkern2, (1024, 128), tab, idx))


@pytest.mark.parametrize("offset", [0, 1, 7])
def test_take_1d_bytes_count_sectors(offset):
    """The bound chip_smoke.py's check_probe2 gives take_1d: the distinct
    32-byte sectors of the table that seeded indices touch (the table a
    view ``offset`` entries into a 32-byte aligned buffer), against a
    numpy count, plus the indices and the output once; and the expected
    count of uniform draws, n_sec (1 - exp(-n / n_sec)), within 1%."""
    gen = np.random.default_rng(4)
    n_tab, n = 120_000, 10_486
    base = torch.zeros(n_tab + 64)
    pad = (-base.data_ptr() % 32) // 4
    tab = base[pad + offset:pad + offset + n_tab]
    idx_np = gen.integers(0, n_tab, n).astype(np.int32)
    idx = torch.as_tensor(idx_np)
    want = np.unique((idx_np.astype(np.int64) + offset) // 8).size
    assert probe2.table_sectors(tab, idx) == want
    assert probe2.take_1d_bytes(tab, idx) == 32 * want + 8 * n
    n_sec = (n_tab + offset + 7) // 8
    assert abs(want / (n_sec * (1 - np.exp(-n / n_sec))) - 1) < 0.01


def test_probe_needs_a_card(monkeypatch):
    """main() imports without a card and refuses to time on the CPU; the
    wrappers raise for a device that is neither, and the kernels are
    registered for the build."""
    with pytest.raises(ValueError, match="card"):
        probe2.main("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        probe2.main()
    meta = torch.empty(4, 128, device="meta")
    idx = torch.empty(4, 128, dtype=torch.int32, device="meta")
    for call in (lambda: probe2.scale2(meta),
                 lambda: probe2.take_1d(meta[0], idx[0]),
                 lambda: probe2.take_along_rows(meta, idx)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    assert (probe2.scale2.launches, probe2.take_1d.launches,
            probe2.take_along_rows.launches) == (0, 0, 0)
    assert "probe2" in cuda.KERNELS
