"""K4's plain version (the vpacket volley) against the JAX package's.

Both trace the same spawn records, made from a numpy seed as in
``tests/test_vpacket.py``, through tables built from one plasma.  The only
arithmetic that differs is the line optical depth of a segment (an f64
prefix difference here, a two-float f32 difference there) and e^-tau (f64
rounded to f32 here, f32 there), a few f32 ulps per ray; so each histogram
bin above 1e-3 of the largest agrees within rtol 1e-4 and the total within
1e-5.  The port's histogram is f64, the JAX package's f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tardis_torch.transport.vpacket import (
    trace_vpacket_records,
    trace_vpacket_records_plain,
)
from tardis_tpu.transport.vpacket import trace_vpacket_records as jax_trace

from tests.test_torch_spawn_records import both_tables

torch.set_num_threads(2)

R = 200
V = 8
BINS = 40


@pytest.fixture(scope="module")
def volley():
    tables, static, pt, _, _ = both_tables("scatter")
    rng = np.random.default_rng(42)
    line_nu = pt.line_nu.numpy()
    r_inner, r_outer = pt.r_inner.numpy(), pt.r_outer.numpy()
    r = rng.uniform(r_inner[0], r_outer[-1] * 0.98, R).astype(np.float32)
    r[:20] = r_inner[0]  # births on the photosphere
    mu = rng.uniform(-1.0, 1.0, R).astype(np.float32)
    nu_mid = float(line_nu[len(line_nu) // 2])
    nu = (nu_mid * rng.uniform(0.9, 1.3, R)).astype(np.float32)
    energy = rng.uniform(0.5, 1.5, R).astype(np.float32)
    energy[::17] = 0.0  # records that carry nothing
    shell = np.searchsorted(r_outer, r).astype(np.int32)
    nu_cmf = nu * (np.float32(1.0) - mu * r)
    next_line = np.searchsorted(-line_nu, -nu_cmf, side="left").astype(
        np.int32)
    edges = np.linspace(nu_mid * 0.3, nu_mid * 2.0, BINS + 1,
                        dtype=np.float32)
    records = torch.as_tensor(np.stack(
        [r, mu, nu, energy, shell.astype(np.float32),
         next_line.astype(np.float32), np.full(R, 1.0, np.float32),
         np.full(R, -1.0, np.float32)], axis=1))

    def jax_run(**kw):
        return jax_trace(
            tables, static, jnp.asarray(r), jnp.asarray(mu), jnp.asarray(nu),
            jnp.asarray(energy), jnp.asarray(shell), jnp.asarray(next_line),
            n_vpackets=V, nu_bin_edges=jnp.asarray(edges), n_bins=BINS, **kw)

    return pt, records, torch.as_tensor(edges), jax_run


def _assert_hist_close(port, ref):
    ref = np.asarray(ref, np.float64)
    big = ref > 1e-3 * ref.max()
    np.testing.assert_allclose(port[big], ref[big], rtol=1e-4)
    np.testing.assert_allclose(port.sum(), ref.sum(), rtol=1e-5)


def test_histogram_matches_jax(volley):
    pt, records, edges, jax_run = volley
    out = trace_vpacket_records(pt, records, V, edges)
    assert out.hist.dtype == torch.float64 and out.hist.shape == (BINS,)
    assert (out.hist > 0).sum() >= 10
    # every ray walks at least one segment; none walks more than 2S + 2
    assert R * V <= int(out.n_segments) <= R * V * (2 * pt.n_shells + 2)
    _assert_hist_close(out.hist.numpy(), jax_run())
    assert not trace_vpacket_records.launches_by_variant  # CPU: no launch


def test_return_packets_match_jax(volley):
    """Per-ray frequencies and attenuated energies: the port lays rays out
    record-major (R, V), the JAX package (V, R)."""
    pt, records, edges, jax_run = volley
    out = trace_vpacket_records_plain(pt, records, V, edges,
                                      return_packets=True)
    h, j_nu, j_e, j_rec = (np.asarray(a) for a in jax_run(return_packets=True))
    _assert_hist_close(out.hist.numpy(), h)
    np.testing.assert_array_equal(j_rec.reshape(V, R)[0], np.arange(R))
    nu = out.nu.numpy().reshape(R, V)
    e = out.energy.numpy().reshape(R, V)
    np.testing.assert_allclose(nu, j_nu.reshape(V, R).T, rtol=1e-6)
    np.testing.assert_allclose(e, j_e.reshape(V, R).T, rtol=1e-4,
                               atol=1e-6 * e.max())
    assert (e[records[:, 3].numpy() == 0] == 0).all()


def test_spawn_range_filters(volley):
    """Records outside the spawn range send nothing: the histogram equals
    the one of the in-range records alone, bit for bit (the others add
    exact zeros), and the JAX package's with the same range."""
    pt, records, edges, jax_run = volley
    nu = records[:, 2]
    lo, hi = float(nu.quantile(0.25)), float(nu.quantile(0.75))
    ranged = trace_vpacket_records_plain(pt, records, V, edges,
                                         spawn_nu_range=(lo, hi))
    inside = (nu >= np.float32(lo)) & (nu <= np.float32(hi))
    alone = trace_vpacket_records_plain(pt, records[inside], V, edges)
    assert 0 < int(inside.sum()) < R
    assert torch.equal(ranged.hist, alone.hist)
    _assert_hist_close(ranged.hist.numpy(),
                       jax_run(spawn_nu_min=lo, spawn_nu_max=hi))


def test_chunking_is_bitwise(volley):
    """The plain version's chunks of 32 records (the last one short) give
    the unchunked result bit for bit: rays keep their record-major order
    and every chunk adds into the same histogram.  (K4 takes every ray in
    one launch; ``chip_smoke.py`` holds it against the chunked plain
    version on the card.)"""
    pt, records, edges, _ = volley
    one = trace_vpacket_records_plain(pt, records, V, edges,
                                      return_packets=True)
    many = trace_vpacket_records_plain(pt, records, V, edges,
                                       return_packets=True,
                                       max_rays_per_chunk=32 * V)
    for name in ("hist", "n_segments", "nu", "energy"):
        assert torch.equal(getattr(one, name), getattr(many, name)), name
