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
  its mean.  The mean is an f64 sum in a fixed order (``fixed_order_sum``:
  chunks of ``WEIGHTED_CHUNK`` packets summed by halves, then the chunks'
  sums by halves), rounded to f32 (the JAX package takes an f32 mean).

Logs and exponentials are taken in f64 and rounded to f32 in the kernel
and in its plain version alike, so the two agree bit for bit and sit
within an ulp of JAX's f32 functions.

On the card the wrapper blocks the host nowhere: the l-table is copied to
each device once (``l_table``), the weighted pool is one launch with its
scratch from the caching allocator, and nothing is read back.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tardis_torch import cuda, tracing
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
WEIGHTED_CHUNK = 2048  # packets a partial sum of the weighted pool's mean
FOLD_WIDTH = 256  # the chunks' sums are folded over at least this width

F32 = np.float32


@functools.lru_cache(maxsize=256)
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


@functools.lru_cache(maxsize=256)
def _relativistic_constants(beta_inner: float):
    """f32 (beta, beta^2, the pool weight (2 beta + 1)/(1 - beta^2)/gamma)."""
    beta = F32(beta_inner)
    bb = F32(beta * beta)
    gamma = F32(F32(1.0) / F32(np.sqrt(F32(F32(1.0) - bb))))
    w = F32(F32(F32(F32(2.0) * beta) + F32(1.0)) / F32(F32(1.0) - bb))
    return beta, bb, F32(w / gamma)


@functools.lru_cache(maxsize=256)
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


_L_TABLES: dict = {}


def l_table(device) -> torch.Tensor:
    """The f32 l-table on ``device``, copied there on the first call for
    that device only (a copy from pageable host memory blocks the host
    until the card has drained its stream).  A CUDA device without an
    index is the current one, as the kernel's launch is."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    t = _L_TABLES.get(device)
    if t is None:
        t = _L_TABLES[device] = torch.as_tensor(_L_ARRAY, device=device)
    return t


def _fold_halves(x):
    """Sum the last dimension (a power of two) by halves: x[j] += x[j+h]
    for h = width/2 .. 1."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def fixed_order_sum(w: torch.Tensor) -> torch.Tensor:
    """The f64 sum of ``w`` in K2's order: chunks of WEIGHTED_CHUNK values
    summed by halves, then the chunks' sums by halves over the next power
    of two >= max(FOLD_WIDTH, chunks).  Missing entries are 0, which
    changes no sum of non-negative values."""
    n = w.numel()
    n_chunks = max(1, -(-n // WEIGHTED_CHUNK))
    x = torch.zeros(n_chunks * WEIGHTED_CHUNK, dtype=torch.float64,
                    device=w.device)
    x[:n] = w.double()
    slots = _fold_halves(x.reshape(n_chunks, WEIGHTED_CHUNK))
    width = FOLD_WIDTH
    while width < n_chunks:
        width *= 2
    y = torch.zeros(width, dtype=torch.float64, device=w.device)
    y[:n_chunks] = slots
    return _fold_halves(y)


def blackbody_source_plain(key, n_packets: int, t_inner: float, device,
                           pool: str = "simple", beta_inner: float = 0.0):
    """Plain PyTorch version of K2 -> (mu, nu_cmf, w), f32, nu / NU_UNIT;
    ``w`` is None for the simple pool."""
    mode = POOLS[pool]
    t_inner, beta_inner = float(t_inner), float(beta_inner)
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
        mean = (fixed_order_sum(w) / n_packets).float()
        return mu, nu, w / mean
    xi = _uniform_columns(k, 6 if mode == POOLS["simple"] else 5, device)
    l_min = (torch.searchsorted(l_table(device), xi[:, 0] * float(_L_COEF))
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


_VP, _CF = ctypes.c_void_p, ctypes.c_float
ARGTYPES = ([ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int64, _VP,
             ctypes.c_int, _CF, _CF, _CF, ctypes.c_int] + [_CF] * 10
            + [_VP] * 4 + [ctypes.POINTER(ctypes.c_int), _VP])


def blackbody_source(key, n_packets: int, t_inner: float, device,
                     pool: str = "simple", beta_inner: float = 0.0):
    """K2 on the card; the plain version when ``device`` is the CPU.

    Returns (mu, nu_cmf, w) as ``blackbody_source_plain``; ``beta_inner``
    (inner boundary velocity / c) is read by the relativistic pool only.
    One launch a call, no copy from the host after a device's first call,
    no synchronisation.  The weighted pool is a cooperative launch; if the
    card refuses it, the call raises with the grid it asked for.
    """
    device = torch.device(device)
    mode = POOLS[pool]
    t_inner, beta_inner = float(t_inner), float(beta_inner)
    if device.type == "cpu":
        return blackbody_source_plain(key, n_packets, t_inner, device, pool,
                                      beta_inner)
    if device.type != "cuda":
        raise ValueError(f"blackbody_source: unsupported device {device}")
    mu = torch.empty(n_packets, dtype=torch.float32, device=device)
    nu = torch.empty(n_packets, dtype=torch.float32, device=device)
    w = (None if mode == POOLS["simple"] else
         torch.empty(n_packets, dtype=torch.float32, device=device))
    weighted = mode == POOLS["weighted"]
    # the weighted pool's f64 partial sums, one a chunk, each written once
    slots = (torch.empty(-(-n_packets // WEIGHTED_CHUNK), dtype=torch.float64,
                         device=device) if weighted else None)
    l_array = None if weighted else l_table(device)
    beta, bb, w_const = (_relativistic_constants(beta_inner)
                         if mode == POOLS["relativistic"] else (F32(0),) * 3)
    h, kt = _x_terms(t_inner)
    fn = cuda.function("blackbody_source", "blackbody_source", ARGTYPES)
    info = (ctypes.c_int * 3)()
    p = cuda.ptr
    launch_args = (
        key[0], key[1], n_packets,
        None if l_array is None else p(l_array), len(_L_ARRAY),
        float(_L_COEF), float(_nu_coef(t_inner)), float(NU_UNIT), mode,
        float(beta), float(bb), float(F32(2.0) * beta), float(w_const),
        float(_LOG_LO), float(_LOG_SPAN), float(h), float(kt),
        *WEIGHTED_X_CLIP, p(mu), p(nu), None if w is None else p(w),
        None if slots is None else p(slots), info, cuda.stream(),
    )
    with tracing.launch(blackbody_source, pool):
        err = fn(*launch_args)
        if err != 0 and weighted:
            raise RuntimeError(
                f"blackbody_source[weighted]: cooperative launch of "
                f"{info[0]} blocks ({info[2]} SMs x {info[1]} blocks a SM) "
                f"failed with CUDA error {err}")
        cuda.check_launch("blackbody_source", err)
    return mu, nu, w


# launches by pool (one a call)
blackbody_source.launches_by_variant = {}
