"""Gamma-ray packet transport for one time step (kernel K6,
``csrc/gamma_step.cu``).

Counterpart of ``tardis_tpu/energy_input/gamma_kernel.py``: the opacities
(Klein-Nishina Compton, Ambwani & Sutherland and Kasen photoabsorption,
pair creation in its tardis and ARTIS forms), the mean Compton energy
fraction, the Klein-Nishina inverse-CDF table and its bilinear lookup,
and ``gamma_step_transport``, which advances every packet of status 0 to
the end of the time step, to its death or to ``max_steps`` events:

1. draws: packet i's j-th uniform of event e is
   ``uniform(fold_in(fold_in(key, e), j))`` at counter i (j = 0: the
   optical depth, minval 1e-9; 1: the interaction split; 2: the Compton
   angle; 3: the azimuth or the pair photon's direction).  The JAX package
   steps every packet of status 0 on each lockstep iteration, so its
   global iteration is the packet's own event count: one thread per packet
   draws the JAX package's bits;
2. the opacities in the packet's shell (or the grey absorption
   grey_opacity x rho), the distance to the interaction, to the shell
   boundary and to the end of the step, the move;
3. Compton scatter (new energy from the sampled angle, new direction about
   the old one with a random azimuth), photoabsorption (death) or pair
   creation (one 511 keV packet, isotropic), each depositing the energy it
   removes; the escape histogram of packets leaving the outer shell
   (energy bins by a search of the edges, side right); with
   ``collect_estimators`` the Kasen deposition, Compton emissivity and
   pair-creation emissivity path-length estimators per shell.

Transcendental functions (log, cos, the fractional powers) are taken in
f64 and rounded to f32, and divisions by constants are divisions by f32
tensors (PyTorch's CUDA division by a Python scalar multiplies by its
reciprocal), so that the plain version and K6 agree bit for bit on the
card; the JAX package's XLA f32 functions agree within an ulp or two.
Deposition, escape histogram and estimators are f64 sums.

``gamma_step_transport`` launches K6 for tensors on the card (two kernel
launches a call: the list of moving packets, then the persistent walk
over it) and runs ``gamma_step_transport_plain`` (lockstep over the
packets still active) only for CPU tensors.  A packet's result depends
only on its own index and state, whichever packets move beside it.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from tardis_torch import cuda
from tardis_torch.constants import SIGMA_THOMSON
from tardis_torch.transport import rng

F32 = torch.float32
F64 = torch.float64

# electron rest energy in keV, value-matched to the reference's
ELECTRON_REST_KEV = 510.9989098062839
# nuclide mass x proton mass, the reference's convention
_M_P = 1.67262192369e-24
MASS_SI = 27.97692653442 * _M_P  # Si-28
MASS_FE = 55.93493633 * _M_P  # Fe-56
FINE_STRUCTURE = 7.2973525693e-3
MAX_STEPS = 10_000
F32_TINY = float(np.finfo(np.float32).tiny)  # smallest normal f32
U_MIN = 1e-9
N_QUADRATURE = 100  # points of the mean Compton fraction
STATUS_ACTIVE, STATUS_ESCAPED, STATUS_ABSORBED, STATUS_TIME = 0, 1, 2, 3
ESTIMATORS = ("kasen_deposition", "compton_emissivity",
              "pair_creation_emissivity")

# K6's compile-time options, in the order of their -D flags
OPTIONS = ("grey", "kasen", "artis", "estimators")


class GammaConstants(ctypes.Structure):
    """The opacities' f32 constants, each rounded once from its f64 value;
    both versions read these values (the C struct of
    ``csrc/gamma_step.cu``)."""

    _fields_ = [(name, ctypes.c_float) for name in (
        "rest_kev", "sigma_t", "si_coef", "fe_coef", "mass_si", "mass_fe",
        "pair_si", "pair_fe", "kasen_coef", "sqrt2", "m_p", "pcs_coef",
        "two_pi")]


CONSTANTS = GammaConstants(
    rest_kev=ELECTRON_REST_KEV, sigma_t=SIGMA_THOMSON, si_coef=1.16e-24,
    fe_coef=25.7e-24, mass_si=MASS_SI, mass_fe=MASS_FE,
    pair_si=14.0**2 / MASS_SI, pair_fe=26.0**2 / MASS_FE,
    kasen_coef=SIGMA_THOMSON * FINE_STRUCTURE**4 * 8.0,
    sqrt2=float(np.sqrt(np.float32(2.0))), m_p=_M_P,
    pcs_coef=3.0 / (16.0 * np.pi) * SIGMA_THOMSON, two_pi=2.0 * np.pi)


_scalars: dict = {}


def _t(value, like):
    """``value`` as an f32 0-d tensor on the device of ``like`` (made once
    per device): a tensor divisor divides exactly on the card."""
    key = (float(value), str(like.device))
    t = _scalars.get(key)
    if t is None:
        t = _scalars[key] = torch.tensor(value, dtype=F32, device=like.device)
    return t


def _c(name, like):
    """Constant ``name`` of ``CONSTANTS`` as an f32 0-d tensor."""
    return _t(getattr(CONSTANTS, name), like)


def _pow(x, exponent):
    """x ** exponent in f64, rounded to f32."""
    return torch.pow(x.double(), exponent).float()


def kappa_e(energy_kev):
    return energy_kev / _c("rest_kev", energy_kev)


def compton_opacity(energy_kev, electron_density):
    """Klein-Nishina total cross-section x n_e [1/cm]; the Thomson-limit
    series 1 - 2k + 5.2 k^2 below k = 0.05."""
    k = torch.clamp(kappa_e(energy_kev), min=1e-6)
    a = 1.0 + 2.0 * k
    log_a = torch.log(a.double()).float()
    full = 0.75 * (
        (1.0 + k) / (k * k * k) * (2.0 * k * (1.0 + k) / a - log_a)
        + log_a / (2.0 * k)
        - (1.0 + 3.0 * k) / (a * a)
    )
    series = 1.0 - 2.0 * k + 5.2 * k * k
    sigma = _c("sigma_t", k) * torch.where(k < 0.05, series, full)
    return electron_density * sigma


def flush_subnormal(x):
    """x, with f32 values below the smallest normal flushed to zero."""
    return torch.where(x.abs() < F32_TINY, torch.zeros_like(x), x)


def photoabsorption_opacity(energy_kev, density, iron_group_fraction):
    """Ambwani & Sutherland (1988) Si / Fe-mix photoabsorption [1/cm].

    The product coefficient x (E / 100 keV)^-n x rho falls below f32's
    normal range in thin ejecta (rho below ~1e-13 g / cm^3 at 0.5-3 MeV);
    the JAX package's platforms flush it to zero (TPU and XLA CPU flush
    f32 subnormals), which zeroes this opacity there, and the port flushes
    it the same way to keep their results equal."""
    x = energy_kev / _t(100.0, energy_kev)
    si = (flush_subnormal(_c("si_coef", x) * _pow(x, -3.13) * density)
          / _c("mass_si", x) * (1.0 - iron_group_fraction))
    fe = (flush_subnormal(_c("fe_coef", x) * _pow(x, -3.0) * density)
          / _c("mass_fe", x) * iron_group_fraction)
    return si + fe


def pair_creation_opacity(energy_kev, density, iron_group_fraction):
    """Ambwani & Sutherland (1988) pair production [1/cm]."""
    mult = density * (_c("pair_si", density) * (1.0 - iron_group_fraction)
                      + _c("pair_fe", density) * iron_group_fraction)
    e_mev = energy_kev / _t(1000.0, energy_kev)
    low = mult * 1.0063 * (e_mev - 1.022) * 1.0e-27
    high = mult * (0.0481 + 0.301 * (e_mev - 1.5)) * 1.0e-27
    return torch.where(energy_kev >= 1500.0, high,
                       torch.where(energy_kev > 1022.0, low, 0.0))


def photoabsorption_opacity_kasen(energy_kev, kasen_z4_sum):
    """Kasen et al. (2006) photoabsorption [1/cm]: sigma_T alpha^4 8
    sqrt(2) kappa^-3.5 sum_i n_i Z_i^4 (the composition sum per shell)."""
    k = torch.clamp(kappa_e(energy_kev), min=1e-6)
    return (_c("kasen_coef", k) * _c("sqrt2", k) * _pow(k, -3.5)
            * kasen_z4_sum)


def pair_creation_opacity_artis(energy_kev, density, iron_group_fraction):
    """The ARTIS pair-creation opacity [1/cm] (thresholds in keV, Z^2 / A
    through 196e-27 (Si) and 784e-27 (Fe) per proton mass)."""
    e = energy_kev
    lo_si = 1.0063 * (e - 1022.0) * 196.0e-27
    hi_si = (0.0481 + 0.301 * (e - 1500.0)) * 196.0e-27
    lo_fe = 1.0063 * (e - 1022.0) * 784.0e-27
    hi_fe = (0.0481 + 0.301 * (e - 1500.0)) * 784.0e-27
    per_p = density / _c("m_p", density)
    op_si = torch.where(e > 1500.0, hi_si, lo_si) * (per_p / _t(28.0, e))
    op_fe = torch.where(e > 1500.0, hi_fe, lo_fe) * (per_p / _t(56.0, e))
    op = op_fe * iron_group_fraction + op_si * (1.0 - iron_group_fraction)
    return torch.where(e > 1022.0, op, 0.0)


_mus: dict = {}


def quadrature_mus(device=None) -> torch.Tensor:
    """The 100 direction cosines of the mean Compton fraction's midpoint
    rule, np.linspace(-1, 1, 100) rounded to f32 (the JAX package's f32
    linspace differs from it in the last bit at some points); one copy per
    device, made on first use (a copy from host memory waits for the
    device's queue)."""
    key = str(torch.device("cpu" if device is None else device))
    t = _mus.get(key)
    if t is None:
        t = _mus[key] = torch.as_tensor(
            np.linspace(-1.0, 1.0, N_QUADRATURE), dtype=F32, device=device)
    return t


def average_compton_fraction(energy_kev):
    """Mean retained energy fraction <E'/E> over the Klein-Nishina angle
    distribution: the 100-point quadrature over mu of f = 1 / (1 + x (1 -
    mu)) weighted by f^2 (f + 1/f - sin^2), each term in f32 and the sums
    in f64, in the order of the points."""
    x = kappa_e(energy_kev)
    mus = quadrature_mus(x.device)
    num = torch.zeros(x.shape, dtype=F64, device=x.device)
    den = torch.zeros_like(num)
    for j in range(N_QUADRATURE):
        mu = mus[j]
        f = 1.0 / (1.0 + x * (1.0 - mu))
        cs = f * f * (f + 1.0 / f - (1.0 - mu * mu))
        num += (cs * f).double()
        den += cs.double()
    return (num / den).float()


def deposition_estimator_kasen(energy_kev, electron_density, density,
                               iron_group_fraction):
    """Kasen deposition opacity [1/cm]: the mean Compton fraction x the
    Compton opacity + the photoabsorption opacity."""
    return (average_compton_fraction(energy_kev)
            * compton_opacity(energy_kev, electron_density)
            + photoabsorption_opacity(energy_kev, density,
                                      iron_group_fraction))


def build_kn_table(n_energy=64, n_quantile=128, e_min=10.0, e_max=5000.0,
                   device=None):
    """Inverse CDF of the Klein-Nishina angle distribution on a log-energy
    grid: (log E grid (n_energy,) f32, cos theta (n_energy, n_quantile)
    f32), computed on the host as the JAX package does."""
    e_grid = np.logspace(np.log10(e_min), np.log10(e_max), n_energy)
    theta = np.linspace(1e-4, np.pi, 512)
    cos_t = np.cos(theta)
    table = np.empty((n_energy, n_quantile), dtype=np.float32)
    q_grid = np.linspace(0.0, 1.0, n_quantile)
    for i, e in enumerate(e_grid):
        k = e / ELECTRON_REST_KEV
        ratio = 1.0 / (1.0 + k * (1.0 - cos_t))
        dsigma = ratio**2 * (ratio + 1.0 / ratio - (1.0 - cos_t**2)) * np.sin(
            theta
        )
        cdf = np.cumsum(dsigma)
        cdf = cdf / cdf[-1]
        table[i] = np.interp(q_grid, cdf, cos_t)
    return (torch.as_tensor(np.log(e_grid).astype(np.float32), device=device),
            torch.as_tensor(table, device=device))


def sample_kn_cos(log_e_grid, table, energy_kev, u):
    """cos theta by bilinear lookup of the inverse-CDF table at (log E,
    u)."""
    n_e, n_q = table.shape
    le = torch.log(torch.clamp(energy_kev, min=1.0).double()).float()
    fi = (le - log_e_grid[0]) / (log_e_grid[-1] - log_e_grid[0]) * (n_e - 1)
    i0 = torch.clamp(fi.to(torch.int32), 0, n_e - 2).long()
    wi = torch.clamp(fi - i0.float(), 0.0, 1.0)
    fq = u * (n_q - 1)
    q0 = torch.clamp(fq.to(torch.int32), 0, n_q - 2).long()
    wq = fq - q0.float()
    flat = table.reshape(-1)
    t00 = flat[i0 * n_q + q0]
    t01 = flat[i0 * n_q + q0 + 1]
    t10 = flat[(i0 + 1) * n_q + q0]
    t11 = flat[(i0 + 1) * n_q + q0 + 1]
    return ((1 - wi) * ((1 - wq) * t00 + wq * t01)
            + wi * ((1 - wq) * t10 + wq * t11))


@dataclass
class GammaStepOutput:
    r: torch.Tensor  # (B,) f32 cm
    mu: torch.Tensor  # (B,) f32
    energy_kev: torch.Tensor  # (B,) f32
    weight: torch.Tensor  # (B,) f32
    shell: torch.Tensor  # (B,) i32
    status: torch.Tensor  # (B,) i32 (0 in flight, 1 escaped, 2 absorbed,
    # 3 at the end of the step)
    deposition: torch.Tensor  # (S,) f64 weight deposited per shell
    escape_hist: torch.Tensor  # (E,) f64 escaping weight per energy bin
    # (3, S) f64 kasen_deposition, compton_emissivity,
    # pair_creation_emissivity ((0, S) without collect_estimators)
    estimators: torch.Tensor
    events: torch.Tensor  # (B,) i32 events of each packet in this step


def variant(grey_opacity=-1.0, photoabsorption_type="tardis",
            pair_creation_type="tardis", collect_estimators=False) -> tuple:
    """The option flags (in ``OPTIONS`` order) of one K6 configuration; the
    grey mode reads neither prescription."""
    if photoabsorption_type not in ("tardis", "kasen"):
        raise ValueError(
            f"invalid photoabsorption opacity type {photoabsorption_type!r}")
    if pair_creation_type not in ("tardis", "artis"):
        raise ValueError(
            f"invalid pair creation opacity type {pair_creation_type!r}")
    grey = grey_opacity >= 0.0
    return (grey, not grey and photoabsorption_type == "kasen",
            not grey and pair_creation_type == "artis",
            bool(collect_estimators))


def variant_name(flags) -> str:
    """``default`` or the options that are on, joined by ``+``."""
    on = [name for name, f in zip(OPTIONS, flags) if f]
    return "+".join(on) if on else "default"


def library_defines(flags) -> tuple:
    """nvcc -D flags of one K6 instantiation."""
    return tuple(f"GS_{name.upper()}={int(f)}"
                 for name, f in zip(OPTIONS, flags))


def _allocate(B, S, E, estimators, device, new_events=torch.zeros):
    """The step's sums, zeroed views of one f64 buffer, and the event
    counts made by ``new_events``: zeroed for the plain version, which adds
    to them; ``torch.empty`` for K6, which writes every packet's count."""
    n_est = 3 if estimators else 0
    sums = torch.zeros(S + E + n_est * S, dtype=F64, device=device)
    events = new_events(B, dtype=torch.int32, device=device)
    return dict(
        deposition=sums[:S],
        escape_hist=sums[S:S + E],
        estimators=sums[S + E:].view(n_est, S),
        events=events,
    )


def gamma_step_transport_plain(r, mu, energy_kev, weight, shell, status,
                               dist_budget, key, r_inner, r_outer,
                               electron_density, density, iron_fraction,
                               kn_log_e, kn_table, ebin_edges,
                               max_steps: int = MAX_STEPS, kasen_z4=None,
                               grey_opacity: float = -1.0,
                               photoabsorption_type: str = "tardis",
                               pair_creation_type: str = "tardis",
                               collect_estimators: bool = False,
                               tally: dict | None = None
                               ) -> GammaStepOutput:
    """Plain PyTorch version of K6: lockstep over the packets still active
    (each steps once per iteration, so the iteration is its event count).
    A ``tally`` dict, when given, receives ``energy_changes``, the number of
    events that changed a packet's energy (Compton scatters and pair
    creations), as a 0-d int64 tensor."""
    grey, kasen, artis, est_on = variant(grey_opacity, photoabsorption_type,
                                         pair_creation_type,
                                         collect_estimators)
    device = r.device
    B, S, E = r.shape[0], r_inner.shape[0], ebin_edges.shape[0] - 1
    acc = _allocate(B, S, E, est_on, device)
    r, mu, e_kev, w = (x.clone() for x in (r, mu, energy_kev, weight))
    shell, status, budget = shell.clone(), status.clone(), dist_budget.clone()
    grey_f = _t(grey_opacity, r)
    energy_changes = torch.zeros((), dtype=torch.int64, device=device)
    for it in range(max_steps):
        idx = (status == STATUS_ACTIVE).nonzero()[:, 0]
        if idx.numel() == 0:
            break
        k = rng.fold_in(key, it)
        bits = [rng.random_bits(rng.fold_in(k, j), idx) for j in range(4)]
        u1 = rng.uniform(bits[0], U_MIN, 1.0)
        u2, u3, phi_u = (rng.uniform(b) for b in bits[1:])
        ri, mui, ei, wi, bi = (x[idx] for x in (r, mu, e_kev, w, budget))
        sh = torch.clamp(shell[idx], 0, S - 1).long()
        rho, ne, fe = density[sh], electron_density[sh], iron_fraction[sh]

        if grey:
            chi_c = torch.zeros_like(ei)
            chi_pp = torch.zeros_like(ei)
            chi_pa = grey_f * rho
        else:
            chi_c = compton_opacity(ei, ne)
            chi_pa = (photoabsorption_opacity_kasen(ei, kasen_z4[sh]) if kasen
                      else photoabsorption_opacity(ei, rho, fe))
            chi_pp = (pair_creation_opacity_artis(ei, rho, fe) if artis
                      else pair_creation_opacity(ei, rho, fe))
        chi_tot = chi_c + chi_pa + chi_pp
        chi_floor = torch.clamp(chi_tot, min=1e-30)
        tau = (-torch.log(u1.double())).float()
        d_int = tau / chi_floor

        r_in, r_out = r_inner[sh], r_outer[sh]
        out_d = torch.sqrt(torch.clamp(
            r_out * r_out + (mui * mui - 1.0) * (ri * ri), min=0.0)) - ri * mui
        check = r_in * r_in + (ri * ri) * (mui * mui - 1.0)
        hits_inner = (mui < 0.0) & (check >= 0.0)
        d_b = torch.clamp(torch.where(
            hits_inner, -ri * mui - torch.sqrt(torch.clamp(check, min=0.0)),
            out_d), min=0.0)
        delta = torch.where(hits_inner, -1, 1)
        d_first = torch.minimum(d_int, d_b)
        d = torch.minimum(d_first, bi)
        ev_time = bi <= d_first
        ev_bound = ~ev_time & (d_b < d_int)
        ev_int = ~ev_time & ~ev_bound

        r_new = torch.sqrt(torch.clamp(
            ri * ri + d * d + 2.0 * ri * d * mui, min=1e-10))
        mu_new = (mui * ri + d) / r_new
        budget[idx] = bi - d

        p_c = chi_c / chi_floor
        p_pa = chi_pa / chi_floor
        is_compton = ev_int & (u2 < p_c)
        is_photo = ev_int & ~is_compton & (u2 < p_c + p_pa)
        is_pair = ev_int & ~is_compton & ~is_photo
        if tally is not None:
            energy_changes += (is_compton | is_pair).sum()

        cos_t = sample_kn_cos(kn_log_e, kn_table, ei, u3)
        e_new = ei / (1.0 + kappa_e(ei) * (1.0 - cos_t))
        frac = e_new / ei
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        sin_old = torch.sqrt(torch.clamp(1.0 - mu_new * mu_new, min=0.0))
        cos_phi = torch.cos((_c("two_pi", phi_u) * phi_u).double()).float()
        mu_scat = torch.clamp(mu_new * cos_t + sin_old * sin_t * cos_phi,
                              -1.0, 1.0)
        mu_pair = 2.0 * phi_u - 1.0

        pair_frac = torch.clamp(
            _t(1022.0, ei) / torch.clamp(ei, min=511.0), 0.0, 1.0)
        dep_inc = (torch.where(is_compton, wi * (1.0 - frac), 0.0)
                   + torch.where(is_photo, wi, 0.0)
                   + torch.where(is_pair, wi * (1.0 - pair_frac), 0.0))
        acc["deposition"].index_add_(0, sh, dep_inc.double())
        if est_on:
            kap_dep = deposition_estimator_kasen(ei, ne, rho, fe)
            ff = 1.0 + kappa_e(ei) * (1.0 - mui)
            pcs = (_c("pcs_coef", ff) / (ff * ff)
                   * (ff + 1.0 / ff + mui * mui - 1.0))
            rows = torch.stack([
                wi * kap_dep * d,
                wi * pcs * d / ff,
                chi_pp * (_t(1022.0, ei) / torch.clamp(ei, min=1.0)) * wi * d,
            ])
            for i in range(3):
                acc["estimators"][i].index_add_(0, sh, rows[i].double())

        e_out = torch.where(is_compton, e_new,
                            torch.where(is_pair, 511.0, ei))
        w_out = torch.where(is_compton, wi * frac,
                            torch.where(is_pair, wi * pair_frac, wi))
        mu_out = torch.where(is_compton, mu_scat,
                             torch.where(is_pair, mu_pair, mu_new))
        new_shell = shell[idx] + torch.where(ev_bound, delta, 0).int()
        escaped = ev_bound & (new_shell >= S)
        absorbed_in = ev_bound & (new_shell < 0)
        bins = torch.clamp(
            torch.searchsorted(ebin_edges, e_out, right=True) - 1, 0, E - 1)
        acc["escape_hist"].index_add_(0, bins[escaped],
                                      w_out[escaped].double())
        status[idx] = torch.where(
            escaped, STATUS_ESCAPED,
            torch.where(is_photo | absorbed_in, STATUS_ABSORBED,
                        torch.where(ev_time, STATUS_TIME,
                                    STATUS_ACTIVE))).int()
        r[idx] = r_new
        mu[idx] = mu_out
        e_kev[idx] = e_out
        w[idx] = w_out
        shell[idx] = torch.where(ev_bound & ~escaped & ~absorbed_in,
                                 new_shell, shell[idx])
        acc["events"][idx] += 1
    if tally is not None:
        tally["energy_changes"] = energy_changes
    return GammaStepOutput(r=r, mu=mu, energy_kev=e_kev, weight=w,
                           shell=shell, status=status, **acc)


# K6's C entry point: 17 inputs, the sizes, the key, the grey opacity and
# the constants, then 12 outputs and scratch and the stream
_ARGTYPES = ([ctypes.c_void_p] * 17
             + [ctypes.c_int64] + [ctypes.c_int] * 5
             + [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float,
                ctypes.POINTER(GammaConstants)]
             + [ctypes.c_void_p] * 12)


def gamma_step_transport(r, mu, energy_kev, weight, shell, status,
                         dist_budget, key, r_inner, r_outer,
                         electron_density, density, iron_fraction, kn_log_e,
                         kn_table, ebin_edges, max_steps: int = MAX_STEPS,
                         kasen_z4=None, grey_opacity: float = -1.0,
                         photoabsorption_type: str = "tardis",
                         pair_creation_type: str = "tardis",
                         collect_estimators: bool = False) -> GammaStepOutput:
    """K6 on the card; the plain version for CPU tensors.  ``key`` is the
    time step's key (a pair of uint32 values); the options select K6's
    compiled instantiation (``variant``)."""
    args = (r, mu, energy_kev, weight, shell, status, dist_budget, key,
            r_inner, r_outer, electron_density, density, iron_fraction,
            kn_log_e, kn_table, ebin_edges)
    opts = dict(grey_opacity=grey_opacity,
                photoabsorption_type=photoabsorption_type,
                pair_creation_type=pair_creation_type,
                collect_estimators=collect_estimators)
    device = r.device
    if device.type == "cpu":
        return gamma_step_transport_plain(*args, max_steps=max_steps,
                                          kasen_z4=kasen_z4, **opts)
    if device.type != "cuda":
        raise ValueError(f"gamma_step_transport: unsupported device {device}")
    flags = variant(**opts)
    if flags[1] and kasen_z4 is None:
        raise ValueError("kasen photoabsorption needs kasen_z4")
    if kasen_z4 is None:
        kasen_z4 = torch.zeros_like(r_inner)
    i32 = torch.int32
    cuda.check_cuda(
        "gamma_step_transport", device, r=(r, F32), mu=(mu, F32),
        energy_kev=(energy_kev, F32), weight=(weight, F32), shell=(shell, i32),
        status=(status, i32), dist_budget=(dist_budget, F32),
        r_inner=(r_inner, F32), r_outer=(r_outer, F32),
        electron_density=(electron_density, F32), density=(density, F32),
        iron_fraction=(iron_fraction, F32), kasen_z4=(kasen_z4, F32),
        kn_log_e=(kn_log_e, F32), kn_table=(kn_table, F32),
        ebin_edges=(ebin_edges, F32))
    B, S, E = r.shape[0], r_inner.shape[0], ebin_edges.shape[0] - 1
    n_e, n_q = kn_table.shape
    if (any(x.shape != (B,) for x in (mu, energy_kev, weight, shell, status,
                                      dist_budget))
            or any(x.shape != (S,) for x in (r_outer, electron_density,
                                             density, iron_fraction,
                                             kasen_z4))
            or kn_log_e.shape != (n_e,) or E < 1 or n_e < 2 or n_q < 2):
        raise ValueError("gamma_step_transport: shapes do not agree")
    if B > 2**31 - 1:
        raise ValueError("gamma_step_transport: more than 2**31 - 1 packets")
    fn = cuda.function("gamma_step", "gamma_step", _ARGTYPES,
                       library_defines(flags))
    acc = _allocate(B, S, E, flags[3], device, torch.empty)
    outs = [torch.empty_like(x) for x in (r, mu, energy_kev, weight, shell,
                                          status)]
    if B == 0:
        return GammaStepOutput(*outs, **acc)
    # two counters, then the list of moving packets
    queue = torch.empty(B + 2, dtype=i32, device=device)
    p = cuda.ptr
    err = fn(
        p(r), p(mu), p(energy_kev), p(weight), p(shell), p(status),
        p(dist_budget), p(r_inner), p(r_outer), p(electron_density),
        p(density), p(iron_fraction), p(kasen_z4), p(kn_log_e), p(kn_table),
        p(ebin_edges), p(quadrature_mus(device)), B, S, E, n_e, n_q,
        max_steps, key[0], key[1], float(grey_opacity),
        ctypes.byref(CONSTANTS), *(p(x) for x in outs),
        p(acc["deposition"]), p(acc["escape_hist"]), p(acc["estimators"]),
        p(acc["events"]), p(queue), cuda.stream(),
    )
    cuda.check_launch("gamma_step_transport", err)
    name = variant_name(flags)
    by = gamma_step_transport.launches_by_variant
    by[name] = by.get(name, 0) + 2
    return GammaStepOutput(*outs, **acc)


# kernel launches by variant_name, two a call (none without packets)
gamma_step_transport.launches_by_variant = {}
