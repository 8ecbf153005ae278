"""Per-iteration line tables: stim, tau, beta, dilute-Planck j_blues and the
per-shell tau prefix, in f64 (kernel K3, ``csrc/line_tables.cu``).

Counterpart of ``tardis_tpu/plasma/device_line.py`` and of the host line
pass in ``tardis_tpu/plasma/solver.py``.  The formulas are those of
``plasma/lte.py`` (stimulated_emission_factor, tau_sobolev, beta_sobolev,
intensity_black_body).  The JAX device program worked in f32 with
log-space populations and a two-float prefix; the H100 has f64, so both
versions here compute in f64 and need neither.

``line_tables`` launches the CUDA kernel for tensors on the card and runs
the plain PyTorch version ``line_tables_plain`` only for CPU tensors.  On
the card the tables are built in three passes over tiles of 64 lines:
the elementwise tables and each tile's tau sums, the tiles' carries, and
the prefix (``csrc/line_tables.cu``).

Under ``detailed`` radiative rates the j_blues table takes the estimators
where they are positive and ``w_epsilon`` times the dilute-Planck value
elsewhere (``tardis_tpu/plasma/solver.py:458-465``): the ``estimators``
instantiation, whose first pass reads the (L, S) estimator table beside
its other inputs.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from tardis_torch import cuda
from tardis_torch.constants import C, H, K_B, SOBOLEV_COEFFICIENT

F64 = torch.float64


@dataclass
class LineStatic:
    """Iteration-invariant per-line inputs on one device."""

    lower_idx: torch.Tensor  # (L,) i32
    upper_idx: torch.Tensor  # (L,) i32
    g_lower: torch.Tensor  # (L,) f64
    g_upper: torch.Tensor  # (L,) f64
    wl_flu: torch.Tensor  # (L,) f64 wavelength [cm] * f_lu
    line_nu: torch.Tensor  # (L,) f64 Hz
    nu3_coef: torch.Tensor  # (L,) f64 2 h nu^3 / c^2
    # the device K3's wrapper last checked these tensors on
    checked_on: torch.device | None = field(default=None, repr=False,
                                            compare=False)

    @classmethod
    def from_atom_data(cls, atom, device) -> "LineStatic":
        nu = atom.line_nu

        def t(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)

        return cls(
            lower_idx=t(atom.line_lower_idx, torch.int32),
            upper_idx=t(atom.line_upper_idx, torch.int32),
            g_lower=t(atom.level_g[atom.line_lower_idx], F64),
            g_upper=t(atom.level_g[atom.line_upper_idx], F64),
            wl_flu=t(atom.line_wavelength_cm * atom.line_f_lu, F64),
            line_nu=t(nu, F64),
            nu3_coef=t(2.0 * H * nu**3 / C**2, F64),
        )


@dataclass
class LineTables:
    stim: torch.Tensor  # (L, S) f64
    tau: torch.Tensor  # (L, S) f64
    beta: torch.Tensor  # (L, S) f64
    j_blues: torch.Tensor  # (L, S) f64
    prefix: torch.Tensor  # (S, L+1) f64 inclusive tau prefix, leading 0


def _shell_inputs(t_rad, jb_w, device):
    t_rad = np.asarray(t_rad, np.float64)
    h_over_kt = torch.as_tensor(H / (K_B * t_rad), dtype=F64, device=device)
    w = torch.as_tensor(np.asarray(jb_w, np.float64), dtype=F64,
                        device=device)
    return h_over_kt, w


def beta_sobolev(tau: torch.Tensor) -> torch.Tensor:
    """Escape probability (1 - exp(-tau)) / tau with K3's stable branches."""
    safe = torch.where(tau > 0, tau, 1.0)
    return torch.where(
        tau > 1e3,
        1.0 / safe,
        torch.where(tau < 1e-4, 1.0 - 0.5 * tau, -torch.expm1(-tau) / safe),
    )


def line_tables_plain(static: LineStatic, level_pop: torch.Tensor, t_rad,
                      jb_w, time_explosion: float,
                      j_estimators: torch.Tensor | None = None,
                      w_epsilon: float = 1e-10) -> LineTables:
    """Plain PyTorch version of K3 (same formulas and evaluation order)."""
    h_over_kt, w = _shell_inputs(t_rad, jb_w, level_pop.device)
    n_lower = level_pop[static.lower_idx.long()]
    n_upper = level_pop[static.upper_idx.long()]
    ratio = (static.g_lower[:, None] * n_upper) / (
        static.g_upper[:, None] * n_lower
    )
    ratio = torch.where(torch.isfinite(ratio), ratio, 1.0)
    stim = torch.clamp(1.0 - ratio, min=0.0)
    tau = (
        SOBOLEV_COEFFICIENT * static.wl_flu[:, None] * time_explosion
        * stim * n_lower
    )
    beta = beta_sobolev(tau)
    x = torch.clamp(static.line_nu[:, None] * h_over_kt[None, :], max=700.0)
    jb = w[None, :] * (static.nu3_coef[:, None] / torch.expm1(x))
    if j_estimators is not None:
        jb = torch.where(j_estimators > 0, j_estimators, w_epsilon * jb)
    S = tau.shape[1]
    prefix = torch.zeros((S, tau.shape[0] + 1), dtype=F64,
                         device=tau.device)
    torch.cumsum(tau.T, dim=1, out=prefix[:, 1:])
    return LineTables(stim=stim, tau=tau, beta=beta, j_blues=jb,
                      prefix=prefix)


# csrc/line_tables.cu: lines per tile, and the shell count whose per-shell
# inputs still go by value in the launch's parameters
TILE = 64
SHELLS_BY_VALUE = 128
_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_double, ctypes.c_double,
                                       ctypes.c_int64, ctypes.c_int]
             + [ctypes.c_void_p] * 7 + [ctypes.c_double, ctypes.c_void_p])


def shell_inputs_packed(t_rad, jb_w) -> np.ndarray:
    """K3's per-shell inputs as one f64 host array [h / (k T_rad), W]: the
    values of ``_shell_inputs``, for the launch's parameters."""
    return np.concatenate((H / (K_B * np.asarray(t_rad, np.float64)),
                           np.asarray(jb_w, np.float64)))


def _check_static(static: LineStatic, device) -> None:
    """The per-line inputs' dtypes, layout and device, checked once per
    ``LineStatic`` and device (they do not change between iterations)."""
    if static.checked_on == device:
        return
    i32 = torch.int32
    cuda.check_cuda(
        "line_tables", device, lower_idx=(static.lower_idx, i32),
        upper_idx=(static.upper_idx, i32), g_lower=(static.g_lower, F64),
        g_upper=(static.g_upper, F64), wl_flu=(static.wl_flu, F64),
        line_nu=(static.line_nu, F64), nu3_coef=(static.nu3_coef, F64),
    )
    static.checked_on = device


def line_tables(static: LineStatic, level_pop: torch.Tensor, t_rad, jb_w,
                time_explosion: float,
                j_estimators: torch.Tensor | None = None,
                w_epsilon: float = 1e-10) -> LineTables:
    """K3 on the card; the plain version for CPU tensors.

    One call launches K3's three passes, one kernel each (``launches``
    counts the kernels, ``launches_by_variant`` by instantiation:
    "default", or "estimators" where the j_blues take the estimators).
    The five outputs and the passes' scratch are one allocation; h / (k
    T_rad) and W go by value in the launch's parameters up to
    SHELLS_BY_VALUE shells, beyond that through one pinned buffer and one
    asynchronous copy.  ``j_estimators`` (L, S) f64, where given, selects
    the estimators instantiation.
    """
    device = level_pop.device
    if device.type == "cpu":
        return line_tables_plain(static, level_pop, t_rad, jb_w,
                                 time_explosion, j_estimators, w_epsilon)
    if device.type != "cuda":
        raise ValueError(f"line_tables: unsupported device {device}")
    level_pop = level_pop.to(F64).contiguous()
    _check_static(static, device)
    cuda.check_cuda("line_tables", device, level_pop=(level_pop, F64))
    if j_estimators is not None:
        cuda.check_cuda("line_tables", device,
                        j_estimators=(j_estimators, F64))
    L = static.line_nu.shape[0]
    S = level_pop.shape[1]
    shell = shell_inputs_packed(t_rad, jb_w)
    shell_dev = None
    if S > SHELLS_BY_VALUE:
        shell_dev = torch.from_numpy(shell).pin_memory().to(
            device, non_blocking=True)
    LS = L * S
    n_scratch = 2 * S * -(-L // TILE)
    buf = torch.empty(4 * LS + S * (L + 1) + n_scratch, dtype=F64,
                      device=device)
    base = buf.data_ptr()
    fn = cuda.function("line_tables", "line_tables", _ARGTYPES)
    err = fn(
        level_pop.data_ptr(), static.lower_idx.data_ptr(),
        static.upper_idx.data_ptr(), static.g_lower.data_ptr(),
        static.g_upper.data_ptr(), static.wl_flu.data_ptr(),
        static.line_nu.data_ptr(), static.nu3_coef.data_ptr(),
        shell.ctypes.data,
        None if shell_dev is None else shell_dev.data_ptr(),
        float(SOBOLEV_COEFFICIENT), float(time_explosion), L, S,
        base, base + 8 * LS, base + 16 * LS, base + 24 * LS, base + 32 * LS,
        base + 8 * (4 * LS + S * (L + 1)),
        None if j_estimators is None else j_estimators.data_ptr(),
        float(w_epsilon), cuda.stream(),
    )
    cuda.check_launch("line_tables", err)
    if L:  # passes A, B and C
        line_tables.launches += 3
        v = "default" if j_estimators is None else "estimators"
        line_tables.launches_by_variant[v] = (
            line_tables.launches_by_variant.get(v, 0) + 3)
    stim, tau, beta, jb = buf[:4 * LS].view(4, L, S).unbind(0)
    return LineTables(stim=stim, tau=tau, beta=beta, j_blues=jb,
                      prefix=buf[4 * LS:4 * LS + S * (L + 1)].view(S, L + 1))


line_tables.launches = 0  # kernel launches, three a call
line_tables.launches_by_variant = {}
