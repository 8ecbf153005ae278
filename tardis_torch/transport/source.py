"""Blackbody packet sources (kernel K2, ``csrc/blackbody_source.cu``).

Counterparts of ``tardis_tpu/transport/source.py``, one kernel with a mode
per pool; packet ``pid`` draws from ``fold_in(key, pid)`` with the JAX
package's threefry bits:

- ``simple`` (``sample_blackbody_packets``): Bjorkman & Wood (2001)
  blackbody frequencies from columns 0-4 and the zero-limb-darkening
  mu = sqrt(column 5);
- ``relativistic`` (``sample_blackbody_packets_relativistic``): the simple
  pool's nu, mu = -beta + sqrt(beta^2 + 2 beta z + z) with z the scalar
  draw of ``fold_in(fold_in(key, pid), 7)``, and the constant weight
  (2 beta + 1) / (1 - beta^2) / gamma;
- ``weighted`` (``sample_blackbody_packets_weighted``): nu log-uniform on
  [1e13, 5e16] Hz from column 0, mu = sqrt(column 1), weight
  nu^4 / expm1(h nu / k T) (the exponent clipped to [1e-6, 80]) divided by
  its mean.  The mean is summed in f64 (the JAX package takes an f32 mean).

Logs and exponentials are taken in f64 and rounded to f32 in the kernel
and in its plain version alike, so the two agree bit for bit (the weighted
pool's mean up to its summation order) and sit within an ulp of JAX's f32
functions.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tardis_torch import cuda
from tardis_torch.constants import H, K_B
from tardis_torch.transport import rng
from tardis_torch.transport.tables import NU_UNIT

_L_SAMPLES = 1000
_L_ARRAY = np.cumsum(
    np.arange(1, _L_SAMPLES, dtype=np.float64) ** -4
).astype(np.float32)
_L_COEF = np.float32(np.pi**4 / 90.0)

POOLS = {"simple": 0, "relativistic": 1, "weighted": 2}
REL_MU_FOLD = 7  # the relativistic mu's key: fold_in(fold_in(key, pid), 7)
WEIGHTED_NU_RANGE = (1e13, 5e16)  # Hz
WEIGHTED_X_CLIP = (1e-6, 80.0)

F32 = np.float32


def _nu_coef(t_inner: float) -> np.float32:
    # (K_B * t_inner / H) evaluated in f32, as the JAX program does
    return (F32(K_B) * F32(t_inner)) / F32(H)


def _log_range():
    """f32 (log(nu_min / NU_UNIT), log(nu_max) - log(nu_min)) of the
    weighted pool, each log correctly rounded."""
    lo, hi = (F32(F32(v) / F32(NU_UNIT)) for v in WEIGHTED_NU_RANGE)
    log_lo = F32(np.log(np.float64(lo)))
    log_hi = F32(np.log(np.float64(hi)))
    return log_lo, F32(log_hi - log_lo)


_LOG_LO, _LOG_SPAN = _log_range()


def _relativistic_constants(beta_inner: float):
    """f32 (beta, beta^2, the pool weight (2 beta + 1)/(1 - beta^2)/gamma)."""
    beta = F32(beta_inner)
    bb = F32(beta * beta)
    gamma = F32(F32(1.0) / F32(np.sqrt(F32(F32(1.0) - bb))))
    w = F32(F32(F32(F32(2.0) * beta) + F32(1.0)) / F32(F32(1.0) - bb))
    return beta, bb, F32(w / gamma)


def _x_terms(t_inner: float):
    """f32 (H, K_B * t_inner): the weighted pool's x = h nu NU_UNIT / k T."""
    return F32(H), F32(K_B) * F32(t_inner)


def _f32(v, device):
    # a tensor operand: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which can differ from K2 by an ulp
    return torch.tensor(v, dtype=torch.float32, device=device)


def _uniform_columns(k, n_cols, device):
    return rng.uniform(rng.random_bits(
        (k[0][:, None], k[1][:, None]),
        torch.arange(n_cols, dtype=torch.int64, device=device)[None, :],
    ))


def blackbody_source_plain(key, n_packets: int, t_inner: float, device,
                           pool: str = "simple", beta_inner: float = 0.0):
    """Plain PyTorch version of K2 -> (mu, nu_cmf, w), f32, nu / NU_UNIT;
    ``w`` is None for the simple pool."""
    mode = POOLS[pool]
    pid = torch.arange(n_packets, dtype=torch.int64, device=device)
    k = rng.fold_in(key, pid)
    if mode == POOLS["weighted"]:
        xi = _uniform_columns(k, 2, device)
        log_nu = (_f32(_LOG_LO, device)
                  + xi[:, 0] * _f32(_LOG_SPAN, device))
        nu = torch.exp(log_nu.double()).float()
        mu = torch.sqrt(xi[:, 1])
        h, kt = _x_terms(t_inner)
        x = ((_f32(h, device) * nu) * _f32(NU_UNIT, device)) / _f32(kt, device)
        x = torch.clamp(x, min=_f32(WEIGHTED_X_CLIP[0], device),
                        max=_f32(WEIGHTED_X_CLIP[1], device))
        w = ((nu * nu) * (nu * nu)) / torch.expm1(x.double()).float()
        mean = (w.double().sum() / n_packets).float()
        return mu, nu, w / mean
    xi = _uniform_columns(k, 6, device)
    l_array = torch.as_tensor(_L_ARRAY, device=device)
    l_min = (torch.searchsorted(l_array, xi[:, 0] * float(_L_COEF))
             + 1).to(torch.float32)
    prod = torch.clamp(((xi[:, 1] * xi[:, 2]) * xi[:, 3]) * xi[:, 4],
                       min=1e-37)
    x = (-torch.log(prod.double())).float() / l_min
    nu = (x * float(_nu_coef(t_inner))) / _f32(NU_UNIT, device)
    if mode == POOLS["simple"]:
        return torch.sqrt(xi[:, 5]), nu, None
    beta, bb, w_const = _relativistic_constants(beta_inner)
    z = rng.uniform(rng.scalar_bits(rng.fold_in(k, REL_MU_FOLD)))
    mu = -_f32(beta, device) + torch.sqrt(
        (_f32(bb, device) + _f32(2.0 * beta, device) * z) + z)
    return mu, nu, torch.full_like(mu, float(w_const))


def blackbody_source(key, n_packets: int, t_inner: float, device,
                     pool: str = "simple", beta_inner: float = 0.0):
    """K2 on the card; the plain version when ``device`` is the CPU.

    Returns (mu, nu_cmf, w) as ``blackbody_source_plain``; ``beta_inner``
    (inner boundary velocity / c) is read by the relativistic pool only.
    """
    device = torch.device(device)
    mode = POOLS[pool]
    if device.type == "cpu":
        return blackbody_source_plain(key, n_packets, t_inner, device, pool,
                                      beta_inner)
    if device.type != "cuda":
        raise ValueError(f"blackbody_source: unsupported device {device}")
    mu = torch.empty(n_packets, dtype=torch.float32, device=device)
    nu = torch.empty(n_packets, dtype=torch.float32, device=device)
    w = (None if mode == POOLS["simple"] else
         torch.empty(n_packets, dtype=torch.float32, device=device))
    # the weighted pool's f64 sum of weights (its mean's numerator)
    w_sum = (torch.zeros(1, dtype=torch.float64, device=device)
             if mode == POOLS["weighted"] else None)
    l_array = torch.as_tensor(_L_ARRAY, device=device)
    beta, bb, w_const = (_relativistic_constants(beta_inner)
                         if mode == POOLS["relativistic"] else (F32(0),) * 3)
    h, kt = _x_terms(t_inner)
    fn = cuda.library("blackbody_source").blackbody_source
    fn.restype = ctypes.c_int
    vp, cf = ctypes.c_void_p, ctypes.c_float
    fn.argtypes = ([ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int64, vp,
                    ctypes.c_int, cf, cf, cf, ctypes.c_int] + [cf] * 10
                   + [vp] * 5)
    p = cuda.ptr
    err = fn(
        key[0], key[1], n_packets, p(l_array), len(_L_ARRAY),
        float(_L_COEF), float(_nu_coef(t_inner)), float(NU_UNIT), mode,
        float(beta), float(bb), float(F32(2.0) * beta), float(w_const),
        float(_LOG_LO), float(_LOG_SPAN), float(h), float(kt),
        *WEIGHTED_X_CLIP, p(mu), p(nu), None if w is None else p(w),
        None if w_sum is None else p(w_sum), cuda.stream(),
    )
    cuda.check_launch("blackbody_source", err)
    by = blackbody_source.launches_by_variant
    by[pool] = by.get(pool, 0) + 1
    if mode == POOLS["weighted"]:  # the same call's normalising launch
        by["weighted_normalize"] = by.get("weighted_normalize", 0) + 1
    return mu, nu, w


# launches by pool, and the weighted pool's normalising launches
blackbody_source.launches_by_variant = {}
