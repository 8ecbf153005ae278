"""Radioactive-isotope decay of model compositions (host numpy).

Copy of ``tardis_tpu/model/decay.py``, the counterpart of the reference's
``IsotopicMassFraction.decay``
(the reference's tardis/model/matter/decay.py, backed by the
``radioactivedecay`` package): isotopic mass fractions specified at
``model_isotope_time_0`` are decayed along their chains to
``time_explosion`` and folded into the elemental mass-fraction table.

Implemented as analytic Bateman solutions over a hand-tabulated set of
supernova-relevant EC/beta+ chains (mass number is conserved along these
chains, so mass fractions transfer 1:1 between members).  Half-lives from
the NNDC Nuclear Wallet Cards (same data the reference pulls in through
``radioactivedecay``).
"""

from __future__ import annotations

import re

import numpy as np

from tardis_torch.atomic.atom_data import SYMBOL_TO_Z

DAY = 86400.0
HOUR = 3600.0
YEAR = 365.25 * DAY
LN2 = np.log(2.0)

# isotope -> (half-life [s], daughter isotope); absent = stable
_HALF_LIVES = {
    "Ni56": (6.075 * DAY, "Co56"),
    "Co56": (77.236 * DAY, "Fe56"),
    "Ni57": (35.60 * HOUR, "Co57"),
    "Co57": (271.74 * DAY, "Fe57"),
    "Cr48": (21.56 * HOUR, "V48"),
    "V48": (15.9735 * DAY, "Ti48"),
    "Fe52": (8.275 * HOUR, "Mn52"),
    "Mn52": (21.1 * 60.0, "Cr52"),  # 52Fe feeds the 21.1-min 52mMn state
    "Ti44": (59.1 * YEAR, "Sc44"),
    "Sc44": (3.97 * HOUR, "Ca44"),
    "Co55": (17.53 * HOUR, "Fe55"),
    "Fe55": (2.744 * YEAR, "Mn55"),
    "Na22": (2.6018 * YEAR, "Ne22"),
    "Al26": (7.17e5 * YEAR, "Mg26"),
    "Mn53": (3.74e6 * YEAR, "Cr53"),
    "Fe59": (44.495 * DAY, "Co59"),
    "Ni63": (101.2 * YEAR, "Cu63"),
    "Ca47": (4.536 * DAY, "Sc47"),
    "Sc47": (3.3492 * DAY, "Ti47"),
}

_ISOTOPE_RE = re.compile(r"^([A-Z][a-z]?)(\d+)$")


def parse_isotope(name: str):
    """'Ni56' -> ('Ni', 56); None if not an isotope label."""
    m = _ISOTOPE_RE.match(name)
    if m is None or m.group(1) not in SYMBOL_TO_Z:
        return None
    return m.group(1), int(m.group(2))


def _chain(isotope: str):
    """[(isotope, lambda)] along the decay chain, stable member last
    (lambda 0)."""
    chain = []
    cur = isotope
    while cur in _HALF_LIVES:
        t_half, daughter = _HALF_LIVES[cur]
        chain.append((cur, LN2 / t_half))
        cur = daughter
    chain.append((cur, 0.0))
    return chain


def decay_fractions(isotope: str, t: float) -> dict:
    """Mass-fraction distribution over chain members after time t.

    Bateman solution for a linear chain with distinct decay constants;
    the returned dict maps isotope labels to the fraction of the initial
    parent mass residing in each member (sums to 1; A conserved).
    """
    chain = _chain(isotope)
    lams = np.array([lam for _, lam in chain])
    out = {}
    remaining = 1.0
    for k, (name, _) in enumerate(chain[:-1]):
        lam_k = lams[: k + 1]
        # N_k(t)/N_1(0) = (prod_{i<k} lam_i) * sum_i exp(-lam_i t)/prod_{j!=i}(lam_j-lam_i)
        coef = np.prod(lam_k[:-1]) if k > 0 else 1.0
        total = 0.0
        for i in range(k + 1):
            denom = np.prod(
                [lam_k[j] - lam_k[i] for j in range(k + 1) if j != i]
            ) if k > 0 else 1.0
            total += np.exp(-lam_k[i] * t) / denom
        frac = float(coef * total)
        out[name] = max(frac, 0.0)
        remaining -= out[name]
    out[chain[-1][0]] = max(remaining, 0.0)
    return out


def decay_isotopic_mass_fractions(
    isotope_fractions: dict, t: float
) -> dict:
    """Decay per-shell isotopic mass fractions to time t.

    Parameters
    ----------
    isotope_fractions : dict
        'Ni56' -> (S,) mass-fraction array at t=0.
    t : float
        Elapsed time [s].

    Returns
    -------
    dict
        atomic number Z -> (S,) elemental mass-fraction contribution.
    """
    elemental = {}
    for iso, frac0 in isotope_fractions.items():
        parsed = parse_isotope(iso)
        if parsed is None:
            raise ValueError(f"unknown isotope label {iso!r}")
        frac0 = np.asarray(frac0, dtype=np.float64)
        for member, share in decay_fractions(iso, t).items():
            if share <= 0.0:
                continue
            sym = parse_isotope(member)[0]
            z = SYMBOL_TO_Z[sym]
            elemental[z] = elemental.get(z, 0.0) + share * frac0
    return elemental


def fold_isotopes_into_elements(
    elements: list,
    fractions: list,
    isotope_fractions: dict,
    t: float,
):
    """Merge decayed isotope contributions into (elements, fractions) lists
    as used by the model readers; returns sorted (atomic_numbers (E,),
    mass_fractions (E, S))."""
    table = {z: np.asarray(f, dtype=np.float64)
             for z, f in zip(elements, fractions)}
    for z, contrib in decay_isotopic_mass_fractions(
        isotope_fractions, t
    ).items():
        table[z] = table.get(z, 0.0) + contrib
    zs = np.array(sorted(table), dtype=np.int64)
    mf = np.stack([table[z] for z in zs])
    return zs, mf
