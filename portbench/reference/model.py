"""The supernova model of a configuration: shells, density, composition and
the starting radiation field (TARDIS's ``specific`` structure with the
``branch85_w7`` density and uniform abundances)."""

from dataclasses import dataclass

import numpy as np

from portbench.reference.constants import (
    B_WIEN,
    C,
    SIGMA_SB,
    SYMBOLS,
    quantity,
)

# W7 (Branch 1985) density law: rho_0 (v / v_0)^-7 at t_0, then t^-3
W7_TIME_0 = 0.000231481 * 86400.0  # s
W7_RHO_0 = 3.0e29  # g / cm^3
W7_V_0 = 1.0e5  # cm / s


@dataclass
class Model:
    v_inner: np.ndarray  # (S,) cm / s
    v_outer: np.ndarray
    time_explosion: float  # s
    density: np.ndarray  # (S,) g / cm^3
    elements: np.ndarray  # (E,) Z, ascending
    mass_fractions: np.ndarray  # (E,) normalized
    luminosity_requested: float  # erg / s
    t_inner: float  # K, at the start
    t_rad: np.ndarray  # (S,) K, at the start
    w: np.ndarray  # (S,) dilution factor at the start

    @property
    def r_inner(self):
        return self.v_inner * self.time_explosion

    @property
    def r_outer(self):
        return self.v_outer * self.time_explosion

    @property
    def volume(self):
        return (4.0 / 3.0) * np.pi * (self.r_outer**3 - self.r_inner**3)


def build_model(cfg: dict, dtype=np.float64) -> Model:
    """The model of TARDIS configuration ``cfg`` (a dict of the YAML's
    keys and quantity strings), its density and starting field rounded to
    ``dtype`` (cgs volumes and luminosities overflow f32, so the arithmetic
    itself stays in f64)."""
    sn, st = cfg["supernova"], cfg["model"]["structure"]
    if st["type"] != "specific" or st["density"]["type"] != "branch85_w7":
        raise ValueError("the reference builds specific W7 structures")
    vel = st["velocity"]
    edges = np.linspace(quantity(vel["start"]), quantity(vel["stop"]),
                        int(vel["num"]) + 1)
    t_exp = quantity(sn["time_explosion"])
    v_mid = 0.5 * (edges[:-1] + edges[1:])
    rho = W7_RHO_0 * (v_mid / W7_V_0) ** -7 * (t_exp / W7_TIME_0) ** -3
    ab = {k: v for k, v in cfg["model"]["abundances"].items() if k != "type"}
    zs = np.array([SYMBOLS.index(s) + 1 for s in ab])
    order = np.argsort(zs)
    fr = np.array([float(v) for v in ab.values()])[order]
    if not np.isclose(fr.sum(), 1.0, atol=1e-8):
        fr = fr / fr.sum()
    lum = quantity(sn["luminosity_requested"])
    r_in0 = edges[0] * t_exp
    t_inner = float((lum / (4.0 * np.pi * r_in0**2 * SIGMA_SB)) ** 0.25)
    t_rad = B_WIEN / ((B_WIEN / t_inner) * (1.0 + (v_mid - edges[0]) / C))
    r_mid = 0.5 * (edges[:-1] + edges[1:]) * t_exp
    w = 0.5 * (1.0 - np.sqrt(np.clip(1.0 - r_in0**2 / r_mid**2, 0.0, None)))
    return Model(v_inner=edges[:-1], v_outer=edges[1:], time_explosion=t_exp,
                 density=rho.astype(dtype), elements=zs[order],
                 mass_fractions=fr, luminosity_requested=lum,
                 t_inner=float(np.asarray(t_inner, dtype)),
                 t_rad=t_rad.astype(dtype),
                 w=w.astype(dtype))
