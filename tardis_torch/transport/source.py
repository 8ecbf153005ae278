"""Blackbody packet source (kernel K2, ``csrc/blackbody_source.cu``).

Counterpart of ``tardis_tpu/transport/source.py`` ``sample_blackbody_packets``:
Bjorkman & Wood (2001) blackbody frequencies and the zero-limb-darkening
mu = sqrt(xi).  Packet ``pid`` draws its six uniforms from
``fold_in(key, pid)`` with the JAX package's threefry bits, so the two
packages build the same pool up to an ulp of the final log.
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


def _nu_coef(t_inner: float) -> np.float32:
    # (K_B * t_inner / H) evaluated in f32, as the JAX program does
    return (np.float32(K_B) * np.float32(t_inner)) / np.float32(H)


def blackbody_source_plain(key, n_packets: int, t_inner: float, device):
    """Plain PyTorch version of K2 -> (mu, nu_cmf), f32, nu / NU_UNIT."""
    pid = torch.arange(n_packets, dtype=torch.int64, device=device)
    k = rng.fold_in(key, pid)
    xi = rng.uniform(rng.random_bits(
        (k[0][:, None], k[1][:, None]),
        torch.arange(6, dtype=torch.int64, device=device)[None, :],
    ))
    l_array = torch.as_tensor(_L_ARRAY, device=device)
    l_min = (torch.searchsorted(l_array, xi[:, 0] * float(_L_COEF))
             + 1).to(torch.float32)
    prod = torch.clamp(((xi[:, 1] * xi[:, 2]) * xi[:, 3]) * xi[:, 4],
                       min=1e-37)
    x = (-torch.log(prod.double())).float() / l_min
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which can differ from K2 by an ulp
    nu_unit = torch.tensor(NU_UNIT, dtype=torch.float32, device=device)
    nu = (x * float(_nu_coef(t_inner))) / nu_unit
    mu = torch.sqrt(xi[:, 5])
    return mu, nu


def blackbody_source(key, n_packets: int, t_inner: float, device):
    """K2 on the card; the plain version when ``device`` is the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return blackbody_source_plain(key, n_packets, t_inner, device)
    if device.type != "cuda":
        raise ValueError(f"blackbody_source: unsupported device {device}")
    mu = torch.empty(n_packets, dtype=torch.float32, device=device)
    nu = torch.empty(n_packets, dtype=torch.float32, device=device)
    l_array = torch.as_tensor(_L_ARRAY, device=device)
    fn = cuda.library("blackbody_source").blackbody_source
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    err = fn(
        key[0], key[1], n_packets, cuda.ptr(l_array), len(_L_ARRAY),
        float(_L_COEF), float(_nu_coef(t_inner)), float(NU_UNIT),
        cuda.ptr(mu), cuda.ptr(nu), cuda.stream(),
    )
    cuda.check_launch("blackbody_source", err)
    blackbody_source.launches += 1
    return mu, nu


blackbody_source.launches = 0
