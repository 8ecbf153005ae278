"""Radioactive decay chains and gamma-ray source sampling (host numpy).

Copy of ``tardis_tpu/energy_input/decay.py`` (the same Philox-keyed draws,
so a pool is bitwise the JAX package's), the counterpart of the
reference's decay machinery
(the reference's tardis/energy_input/gamma_ray_channel.py:6-67,
decay_radiation.py, nuclear_energy_source.py, samplers.py,
energy_source.py:255), for arbitrary linear decay chains:

- chains come from the same hand-tabulated half-life table the model decay
  uses (model/decay.py _HALF_LIVES — the in-image stand-in for the
  ``radioactivedecay`` package the reference imports);
- per-isotope radiation data (gamma lines, positron intensity and mean
  kinetic energy) lives in :data:`DECAY_RADIATION`, the in-image analogue of
  the reference's carsus ``decay_radiation_data`` table
  (decay_radiation.py:6-67; NNDC evaluated data);
- populations and per-window decay counts use the general Bateman solution
  (:func:`chain_decay_windows`), not a two-member special case;
- positron kinetic energy is deposited locally in the emitting shell
  (reference ``energy_source.py:255`` positron fraction) and annihilation
  511 keV photons are emitted with intensity 2 x positron intensity;
- packet sampling uses a **counter-based Philox generator** keyed by the
  seed (numpy ``Philox``: the same counter-based reproducibility contract
  as the transport kernels' threefry).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from tardis_torch.constants import M_U
from tardis_torch.model.decay import _HALF_LIVES, _chain, parse_isotope

KEV = 1.602176634e-9  # erg

# half lives [s] (kept as module constants for the Ni/Co convenience API)
T_HALF_NI56 = _HALF_LIVES["Ni56"][0]
T_HALF_CO56 = _HALF_LIVES["Co56"][0]
LAMBDA_NI56 = np.log(2.0) / T_HALF_NI56
LAMBDA_CO56 = np.log(2.0) / T_HALF_CO56

M_NI56 = 55.942128 * 1.6605390666e-24  # g


@dataclass
class IsotopeRadiation:
    """Radiation emitted per decay of one isotope (NNDC evaluated data;
    the analogue of one isotope's rows in the reference's carsus
    decay_radiation_data table, decay_radiation.py:40-67)."""

    # (n, 2): [gamma-line energy keV, photons per decay] — WITHOUT the
    # 511 keV annihilation photons (generated from positron_intensity)
    gamma_lines: np.ndarray
    positron_intensity: float = 0.0  # positrons per decay
    positron_mean_kev: float = 0.0  # mean positron kinetic energy


def _lines(*pairs):
    return np.array(pairs, dtype=np.float64).reshape(-1, 2)


# NNDC Nuclear Wallet Cards / ENSDF principal lines for the supernova-
# relevant isotopes of model/decay._HALF_LIVES.  Stable daughters and
# pure-EC X-ray emitters carry empty tables.
DECAY_RADIATION: dict[str, IsotopeRadiation] = {
    "Ni56": IsotopeRadiation(
        _lines((158.38, 0.988), (269.50, 0.365), (480.44, 0.365),
               (749.95, 0.495), (811.85, 0.860), (1561.80, 0.140)),
    ),
    "Co56": IsotopeRadiation(
        _lines((846.77, 0.999), (977.37, 0.014), (1037.84, 0.141),
               (1175.10, 0.023), (1238.29, 0.665), (1360.21, 0.043),
               (1771.35, 0.155), (2015.18, 0.030), (2034.76, 0.078),
               (2598.46, 0.169), (3253.42, 0.079)),
        positron_intensity=0.194,
        positron_mean_kev=610.0,
    ),
    "Ni57": IsotopeRadiation(
        _lines((1377.63, 0.817), (127.16, 0.167), (1919.52, 0.123)),
        positron_intensity=0.436,
        positron_mean_kev=354.0,
    ),
    "Co57": IsotopeRadiation(
        _lines((122.06, 0.856), (136.47, 0.1068), (14.41, 0.0916)),
    ),
    "Cr48": IsotopeRadiation(
        _lines((112.31, 0.960), (308.24, 1.000)),
        positron_intensity=0.016,
        positron_mean_kev=199.0,
    ),
    "V48": IsotopeRadiation(
        _lines((983.53, 0.9998), (1312.11, 0.982), (944.13, 0.0787),
               (2240.40, 0.0233)),
        positron_intensity=0.4997,
        positron_mean_kev=290.0,
    ),
    "Fe52": IsotopeRadiation(
        _lines((168.69, 0.992)),
        positron_intensity=0.555,
        positron_mean_kev=340.0,
    ),
    "Mn52": IsotopeRadiation(  # 52mMn fed by 52Fe
        _lines((1434.07, 0.982)),
        positron_intensity=0.966,
        positron_mean_kev=1174.0,
    ),
    "Ti44": IsotopeRadiation(
        _lines((78.32, 0.964), (67.87, 0.930)),
    ),
    "Sc44": IsotopeRadiation(
        _lines((1157.02, 0.999)),
        positron_intensity=0.943,
        positron_mean_kev=632.0,
    ),
    "Co55": IsotopeRadiation(
        _lines((931.10, 0.750), (477.20, 0.202), (1408.50, 0.169)),
        positron_intensity=0.760,
        positron_mean_kev=570.0,
    ),
    "Fe55": IsotopeRadiation(_lines()),  # pure EC, X-rays only
    "Na22": IsotopeRadiation(
        _lines((1274.54, 0.9994)),
        positron_intensity=0.9033,
        positron_mean_kev=215.5,
    ),
    "Sc47": IsotopeRadiation(_lines((159.38, 0.683))),  # beta-
    "Ca47": IsotopeRadiation(
        _lines((1297.09, 0.670), (489.23, 0.062), (807.86, 0.062))
    ),
}

ANNIHILATION_KEV = 511.0
# para-positronium fraction among positronium formations (reference
# PARA_TO_ORTHO_RATIO, transport/montecarlo/packet_source/high_energy.py)
PARA_TO_ORTHO_RATIO = 0.25
ELECTRON_MASS_ENERGY_KEV = 510.998928


def positronium_continuum(num: int = 100):
    """Ortho-positronium three-photon decay continuum (Ore & Powell 1949).

    Returns (energy [keV], intensity normalized to max 1) on a ``num``-point
    grid — matching the reference's ``positronium_continuum``
    (the reference's tardis/energy_input/energy_source.py:255-280).
    """
    energy = np.linspace(1, ELECTRON_MASS_ENERGY_KEV, num=num,
                         endpoint=False)
    x = energy / ELECTRON_MASS_ENERGY_KEV
    omx = 1.0 - x
    term_1 = (x * omx) / (2.0 - x) ** 2
    term_2 = (2.0 * omx**2) / (2.0 - x) ** 3 * np.log(omx)
    term_3 = (2.0 - x) / x
    term_4 = (2.0 * omx) / x**2 * np.log(omx)
    intensity = 2.0 * (term_1 - term_2 + term_3 + term_4)
    return energy, intensity / np.max(intensity)


class PositroniumSampler:
    """Inverse-CDF sampler of the ortho-Ps photon energy distribution.

    Construction matches the reference's ``PositroniumSampler``
    (the reference's tardis/energy_input/samplers.py:146-200): the Ore &
    Powell (1949) PDF on x = E / m_e c^2 over a dense grid, normalized,
    cumulative-summed, inverted by linear interpolation.
    """

    def __init__(self, n_grid: int = 10000):
        self.x_grid = np.linspace(1e-4, 0.9999, n_grid)
        pdf = self.pdf(self.x_grid)
        self.norm_pdf = pdf / np.trapezoid(pdf, self.x_grid)
        self.cdf_grid = np.cumsum(self.norm_pdf)
        self.cdf_grid /= self.cdf_grid[-1]

    @staticmethod
    def pdf(x):
        first = x * (1 - x) / (2 - x) ** 2
        second = 2 * (1 - x) ** 2 * np.log(1 - x) / (2 - x) ** 3
        third = (2 - x) / x
        fourth = 2 * (1 - x) * np.log(1 - x) / x**2
        return 2 * (first - second + third + fourth)

    def sample_energy(self, rng, samples: int):
        """Sample ``samples`` photon energies [keV] using draws from the
        counter-based generator ``rng``."""
        z = rng.random(samples)
        x = np.interp(z, self.cdf_grid, self.x_grid)
        return x * ELECTRON_MASS_ENERGY_KEV


def decay_radiation_from_atom_data(atom_data) -> dict:
    """Parse a carsus ``decay_radiation_data`` table into per-isotope
    :class:`IsotopeRadiation` entries (reference decay_radiation.py:6-67:
    columns Z, A, Radiation, Rad Energy [keV], Rad Intensity [%]).

    Returns {} when the atomic dataset carries no such table; entries
    override the built-in NNDC values when present.
    """
    df = getattr(atom_data, "meta", {}).get("decay_radiation_data")
    if df is None:
        return {}
    from tardis_torch.atomic.atom_data import ATOMIC_SYMBOLS

    d = df.reset_index()
    norm = {c.lower().replace(" ", "_"): c for c in d.columns}

    def col(*names):
        for n in names:
            if n in norm:
                return d[norm[n]]
        return None

    z = col("z", "atomic_number")
    a = col("a", "mass_number")
    rtype = col("radiation", "radiation_type")
    energy = col("rad_energy", "radiation_energy_kev")
    inten = col("rad_intensity", "rad_intensity")
    if any(v is None for v in (z, a, rtype, energy, inten)):
        raise ValueError(
            "decay_radiation_data table lacks the reference's columns "
            "(Z, A, Radiation, Rad Energy, Rad Intensity)"
        )
    z = np.asarray(z, np.int64)
    a = np.asarray(a, np.int64)
    rtype = np.asarray(rtype).astype(str)
    energy = np.asarray(energy, np.float64)
    frac = np.asarray(inten, np.float64) / 100.0  # per 100 decays

    out = {}
    for zz, aa in {(int(x), int(y)) for x, y in zip(z, a)}:
        sel = (z == zz) & (a == aa)
        label = f"{ATOMIC_SYMBOLS[zz - 1]}{aa}"
        is_g = sel & np.char.startswith(rtype, "g")
        # beta-plus rows carry the positron mean kinetic energy
        is_bp = sel & (
            np.char.startswith(rtype, "bp")
            | np.char.startswith(rtype, "e+")
        )
        glines = np.column_stack([energy[is_g], frac[is_g]]) if \
            is_g.any() else _lines()
        pos_int = float(frac[is_bp].sum())
        pos_mean = (
            float((energy[is_bp] * frac[is_bp]).sum() / pos_int)
            if pos_int > 0 else 0.0
        )
        out[label] = IsotopeRadiation(
            gamma_lines=np.asarray(glines, np.float64).reshape(-1, 2),
            positron_intensity=pos_int,
            positron_mean_kev=pos_mean,
        )
    return out


def radiation_for(member: str, radiation: dict | None = None
                  ) -> IsotopeRadiation:
    """Radiation table for a chain member (empty for unknown/stable).

    ``radiation`` optionally overrides/extends the built-in NNDC table —
    e.g. the parsed carsus decay_radiation_data
    (:func:`decay_radiation_from_atom_data`)."""
    table = DECAY_RADIATION if radiation is None else radiation
    return table.get(member, IsotopeRadiation(_lines()))


def gamma_energy_per_decay(member: str, radiation: dict | None = None
                           ) -> float:
    """keV of gamma radiation per decay, INCLUDING annihilation photons."""
    rad = radiation_for(member, radiation)
    e = float((rad.gamma_lines[:, 0] * rad.gamma_lines[:, 1]).sum()) \
        if len(rad.gamma_lines) else 0.0
    return e + 2.0 * ANNIHILATION_KEV * rad.positron_intensity


def positron_energy_per_decay(member: str, radiation: dict | None = None
                              ) -> float:
    """keV of positron KINETIC energy per decay (deposited locally)."""
    rad = radiation_for(member, radiation)
    return rad.positron_intensity * rad.positron_mean_kev


ENERGY_PER_DECAY_NI56 = gamma_energy_per_decay("Ni56")
ENERGY_PER_DECAY_CO56 = gamma_energy_per_decay("Co56")


# ---------------------------------------------------------------------------
# general Bateman machinery
# ---------------------------------------------------------------------------


def chain_decay_windows(isotope: str, t_edges: np.ndarray) -> dict:
    """Decays per chain member per time window, per initial parent nucleus.

    General Bateman solution for the linear chain starting at ``isotope``
    (chains from model/decay._HALF_LIVES; distinct decay constants):

        N_k(t) = sum_i c_ki exp(-lambda_i t),
        c_ki = (prod_{j<k} lambda_j) / prod_{j<=k, j != i}(lambda_j - lambda_i)

    and the decays of member k in [t0, t1] are the exact integral
    ``lambda_k \\int N_k dt``.  Returns {member: (B,) decays per window}
    for the RADIOACTIVE members (the stable terminus never decays).
    """
    t_edges = np.asarray(t_edges, np.float64)
    chain = _chain(isotope)
    lams = np.array([lam for _, lam in chain[:-1]])
    out = {}
    for k in range(len(lams)):
        lk = lams[: k + 1]
        coef = float(np.prod(lk[:-1])) if k > 0 else 1.0
        c = np.empty(k + 1)
        for i in range(k + 1):
            denom = (
                np.prod([lk[j] - lk[i] for j in range(k + 1) if j != i])
                if k > 0
                else 1.0
            )
            c[i] = coef / denom
        e = np.exp(-np.outer(t_edges, lk))  # (B+1, k+1)
        per_exp = (e[:-1] - e[1:]) / lk[None, :]  # (B, k+1)
        out[chain[k][0]] = lams[k] * (per_exp @ c)
    return out


def bateman_ni_co(n_ni0: np.ndarray, t: float):
    """Ni56 and Co56 numbers at time t from initial Ni56 numbers
    (two-member convenience wrapper around the general solution)."""
    ni = n_ni0 * np.exp(-LAMBDA_NI56 * t)
    co = (
        n_ni0
        * LAMBDA_NI56
        / (LAMBDA_CO56 - LAMBDA_NI56)
        * (np.exp(-LAMBDA_NI56 * t) - np.exp(-LAMBDA_CO56 * t))
    )
    return ni, co


def decay_energy_per_shell(n_ni0: np.ndarray, t0: float, t1: float):
    """Gamma-ray energy [erg] emitted per shell in [t0, t1] (Ni56 chain)."""
    d = chain_decay_windows("Ni56", np.array([t0, t1]))
    e_ni = d["Ni56"][0] * n_ni0 * ENERGY_PER_DECAY_NI56 * KEV
    e_co = d["Co56"][0] * n_ni0 * ENERGY_PER_DECAY_CO56 * KEV
    return e_ni, e_co


def isotope_numbers_from_fractions(
    isotope_mass_fractions: dict, shell_masses: np.ndarray
) -> dict:
    """{'Ni56': (S,) mass fraction} -> {'Ni56': (S,) nucleus counts}."""
    out = {}
    S = len(shell_masses)
    for iso, frac in isotope_mass_fractions.items():
        parsed = parse_isotope(iso)
        if parsed is None:
            raise ValueError(f"unknown isotope label {iso!r}")
        a = parsed[1]
        frac = np.broadcast_to(np.asarray(frac, np.float64), (S,))
        out[iso] = frac * shell_masses / (a * M_U)
    return out


# ---------------------------------------------------------------------------
# packet sampling
# ---------------------------------------------------------------------------


@dataclass
class GammaPacketPool:
    """Host-sampled initial gamma packets."""

    shell: np.ndarray  # (N,) int32
    radius_frac: np.ndarray  # (N,) fractional position within shell (volume)
    mu: np.ndarray  # (N,) direction cosine
    energy_kev: np.ndarray  # (N,) photon energy
    time: np.ndarray  # (N,) decay time [s]
    packet_energy: np.ndarray  # (N,) erg carried per packet
    total_energy: float  # erg (gamma radiation sampled into packets)
    # per-(shell, time-bin) positron kinetic energy [erg], deposited
    # locally by the workflow (reference energy_source.py:255)
    positron_energy: np.ndarray = None  # (S, B)
    time_bin_edges: np.ndarray = None  # (B+1,)
    member: np.ndarray = None  # (N,) int32 index into members
    members: list = field(default_factory=list)  # chain-member labels


def sample_gamma_packets(
    n_packets: int,
    isotope_numbers,  # dict {'Ni56': (S,) counts}  (legacy: (S,) = Ni56)
    t_start: float,
    t_end: float,
    seed: int = 0,
    n_time_bins: int = 64,
    radiation: dict | None = None,  # per-isotope IsotopeRadiation override
    positronium_fraction: float = 0.0,
) -> GammaPacketPool:
    """Sample decay gamma packets over (chain member, shell, time, line).

    Packets carry equal energy = E_total / N (the reference's convention,
    main_gamma_ray_loop.py:145-260).  Draws come from a counter-based
    Philox generator keyed by ``seed``.

    ``positronium_fraction``: probability that a positron forms positronium
    before annihilating (reference ``create_packet_nus``,
    transport/montecarlo/packet_source/high_energy.py:140-206): of the
    511 keV annihilation packets, that fraction re-routes — 75% (ortho-Ps)
    draw their photon energy from the Ore & Powell three-photon continuum,
    25% (para-Ps, PARA_TO_ORTHO_RATIO) stay at 511 keV.  Packet ENERGY is
    unchanged (only the photon frequency), matching the reference, so
    energy bookkeeping is unaffected.
    """
    if not isinstance(isotope_numbers, dict):
        isotope_numbers = {"Ni56": np.asarray(isotope_numbers)}
    rng = np.random.Generator(np.random.Philox(key=np.uint64(seed)))
    S = len(next(iter(isotope_numbers.values())))
    t_edges = np.logspace(
        np.log10(t_start), np.log10(t_end), n_time_bins + 1
    )

    # decays per (member, shell, bin), accumulated over all parent chains
    decays: dict[str, np.ndarray] = {}
    for iso, n0 in isotope_numbers.items():
        for member, per_nucleus in chain_decay_windows(iso, t_edges).items():
            contrib = np.outer(np.asarray(n0, np.float64), per_nucleus)
            decays[member] = decays.get(member, 0.0) + contrib  # (S, B)

    members = sorted(
        m for m in decays
        if gamma_energy_per_decay(m, radiation) > 0
        or positron_energy_per_decay(m, radiation) > 0
    )
    if not members:
        raise ValueError("no radioactive gamma/positron emitters in input")

    # gamma energy per (member, shell, bin) [erg]
    weights = np.stack(
        [decays[m] * gamma_energy_per_decay(m, radiation) * KEV
         for m in members]
    )  # (M, S, B)
    total = float(weights.sum())
    # positron kinetic energy per (shell, bin) [erg] — local deposition
    positron = sum(
        decays[m] * positron_energy_per_decay(m, radiation) * KEV
        for m in members
    )
    positron = np.asarray(positron, np.float64).reshape(S, n_time_bins)

    p = (weights / total).reshape(-1)
    choice = rng.choice(len(p), size=n_packets, p=p)
    member_idx = choice // (S * n_time_bins)
    rem = choice % (S * n_time_bins)
    shell = rem // n_time_bins
    tbin = rem % n_time_bins

    time = t_edges[tbin] * (
        t_edges[tbin + 1] / t_edges[tbin]
    ) ** rng.random(n_packets)
    mu = 2.0 * rng.random(n_packets) - 1.0
    radius_frac = rng.random(n_packets) ** (1.0 / 3.0)

    energy_kev = np.empty(n_packets)
    for mi, m in enumerate(members):
        sel = member_idx == mi
        if not sel.any():
            continue
        rad = radiation_for(m, radiation)
        lines = rad.gamma_lines
        if rad.positron_intensity > 0:
            lines = np.vstack(
                [lines,
                 [[ANNIHILATION_KEV, 2.0 * rad.positron_intensity]]]
            )
        pl = lines[:, 0] * lines[:, 1]
        pl = pl / pl.sum()
        idx = rng.choice(len(lines), size=int(sel.sum()), p=pl)
        energy_kev[sel] = lines[idx, 0]

    if positronium_fraction > 0.0:
        annihilation = energy_kev == ANNIHILATION_KEV
        forms_ps = rng.random(n_packets) < positronium_fraction
        three_photon = rng.random(n_packets) > PARA_TO_ORTHO_RATIO
        ortho = annihilation & forms_ps & three_photon
        n_ortho = int(ortho.sum())
        if n_ortho:
            energy_kev[ortho] = PositroniumSampler().sample_energy(
                rng, n_ortho
            )
        # para-Ps and non-forming positrons keep the 511 keV line

    return GammaPacketPool(
        shell=shell.astype(np.int32),
        radius_frac=radius_frac,
        mu=mu,
        energy_kev=energy_kev,
        time=time,
        packet_energy=np.full(n_packets, total / n_packets),
        total_energy=total,
        positron_energy=positron,
        time_bin_edges=t_edges,
        member=member_idx.astype(np.int32),
        members=members,
    )
