"""Convergence strategy: damped updates + convergence detection.

Mirrors the reference's ``ConvergenceSolver``
(tardis/simulation/convergence.py:4-131) and the
hold-iterations logic in ``Simulation`` (simulation/base.py:235-268).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ConvergenceSolver:
    damping_constant: float = 0.5
    threshold: float = 0.05
    fraction: float = 0.8
    type: str = "damped"
    # adaptive_damped search window (reference simulation/convergence.py:28-30)
    lambda_min: float = 0.1
    lambda_max: float = 1.0
    lambda_step: float = 0.05

    def converge(self, value, estimated):
        """Damped update: value + d * (estimated - value); for the
        ``adaptive_damped`` strategy the damping constant is locally searched
        per call (reference simulation/convergence.py:63-106)."""
        if self.type == "adaptive_damped":
            return self._adaptive_damped(value, estimated)
        return value + self.damping_constant * (estimated - value)

    def _adaptive_damped(self, value, estimated):
        """Pick the step among {λ, λ±Δ} ∩ [λ_min, λ_max] minimizing the mean
        relative residual to the estimate; update λ in place."""
        base = self.damping_constant
        candidates = [base]
        if base - self.lambda_step >= self.lambda_min:
            candidates.append(base - self.lambda_step)
        if base + self.lambda_step <= self.lambda_max:
            candidates.append(base + self.lambda_step)
        best = None
        for lam in candidates:
            x_new = value + lam * (estimated - value)
            res = float(np.mean(np.abs((estimated - x_new) / estimated)))
            if best is None or res < best[0]:
                best = (res, lam, x_new)
        self.damping_constant = best[1]
        return best[2]

    def get_convergence_status(self, value, estimated, no_of_cells) -> bool:
        """True if >= `fraction` of cells changed by less than `threshold`
        (reference simulation/convergence.py:109-130)."""
        value = np.atleast_1d(np.asarray(value, dtype=np.float64))
        estimated = np.atleast_1d(np.asarray(estimated, dtype=np.float64))
        frac_conv = np.mean(
            np.abs(estimated - value) / np.abs(value) < self.threshold
        )
        if no_of_cells == 1:
            return bool(frac_conv == 1.0)
        return bool(frac_conv > self.fraction)


@dataclass
class ConvergenceState:
    """Tracks consecutive-converged count / hold iterations."""

    hold_iterations: int = 3
    consecutive_converges: int = 0
    converged: bool = False

    def update(self, all_converged: bool) -> bool:
        if all_converged:
            self.consecutive_converges += 1
            self.converged = (
                self.consecutive_converges >= self.hold_iterations + 1
            )
        else:
            self.consecutive_converges = 0
            self.converged = False
        return self.converged


def make_convergence_solvers(strategy: dict):
    """Build per-quantity solvers from the montecarlo.convergence_strategy
    config section."""
    kind = strategy.get("type", "damped")
    # reference hard-resets the adaptive starting factor to 0.5 regardless
    # of config (simulation/convergence.py adaptive initialization)
    default_d = 0.5 if kind == "adaptive_damped" else 1.0
    base_d = strategy.get("damping_constant", default_d)
    thr = strategy.get("threshold", 0.05)
    frac = strategy.get("fraction", 0.8)
    if kind not in ("damped", "adaptive_damped"):
        raise NotImplementedError(
            f"convergence strategy type {kind!r} (custom is not implemented "
            "in the reference either, simulation/convergence.py:36-44)"
        )

    def solver(sub):
        s = strategy.get(sub, {}) or {}
        return ConvergenceSolver(
            damping_constant=s.get("damping_constant", base_d),
            threshold=s.get("threshold", thr),
            fraction=frac,
            type=kind,
        )

    return {
        "t_rad": solver("t_rad"),
        "w": solver("w"),
        "t_inner": solver("t_inner"),
    }
