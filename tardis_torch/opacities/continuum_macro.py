"""Continuum macro-atom: extended state space + absorbing Markov chain.

Counterpart of ``tardis_tpu/opacities/continuum_macro.py``, copied: host
numpy f64 in both packages, once per iteration.  It realizes the
reference's ContinuumMacroAtomSolver
(tardis/opacities/macro_atom/macroatom_solver.py:793-1100) and
create_absorbing_probs (macro_atom/absorbing_markov_chain.py:19-130):

- The state space is {bound-bound macro levels} U {i-packet states (ground
  levels of the next ion)} U {k-packet}.
- All channels (bound-bound radiative, photoionization/recombination,
  collisional, k-packet cooling) are assembled as unnormalized rate x energy
  probabilities (Lucy 2003 convention; bound-bound coefficients are scaled by
  c_einstein to match, cf. iip_plasma/continuum/radiative_processes.py:395).
- Internal transitions are folded into the **absorbing-probability matrix**
  B[shell, from, to] = N R via a dense per-shell linear solve, so the
  in-kernel interaction is two categorical draws (binary searches in K1's
  continuum branch, ``transport/kernel.py``).
- Deactivation channels are stored as per-state cumulative blocks with an
  emission kind (``EMIT_*``).

The port's plasma state keeps its (L, S) line tables on the device (K3);
they are read back to the host once per call here.  Channel probability
formulas follow macro_atom/macroatom_continuum_transitions.py:10-818.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tardis_torch.atomic.atom_data import (
    MACRO_INTERNAL_UP,
    AtomData,
)
from tardis_torch.constants import C, E_CHARGE, H, K_B, M_E

# c_einstein = 4 (pi e)^2 / (c m_e)
# (reference iip_plasma/continuum/constants.py:10-12)
C_EINSTEIN = float(4.0 * (np.pi * E_CHARGE) ** 2 / (C * M_E))

# deactivation emission kinds (kernel dispatch codes)
EMIT_LINE = 0
EMIT_BF = 1
EMIT_FF = 2
EMIT_TWO_PHOTON = 3  # reference MacroAtomTransitionType.TWO_PHOTON (-6)
# adiabatic cooling: the k-packet's energy goes into expansion work and
# the packet is destroyed (reference MacroAtomTransitionType.
# ADIABATIC_COOLING (-4) + interaction_events.py:130 adiabatic_cooling)
EMIT_ADIABATIC = 4


@dataclass
class ContinuumMacroState:
    """Kernel-ready continuum macro-atom tables."""

    n_states: int
    # cumulative absorbing probabilities, row-normalized: (S, M, M)
    cum_B: np.ndarray  # f32
    # deactivation blocks (CSR over states)
    deact_block_start: np.ndarray  # (M+1,) i32
    deact_cum_prob: np.ndarray  # (D, S) f32 cumulative per block
    deact_kind: np.ndarray  # (D,) int8
    deact_id: np.ndarray  # (D,) i32 line id (kind 0) or continuum id (kind 1)
    # activation maps
    line2state: np.ndarray  # (L,) i32 state activated by line absorption
    photo_ion_state: np.ndarray  # (C,) i32 i-packet state per continuum
    k_state: int
    # number of active two-photon deactivation channels (0 = disabled)
    n_two_photon: int = 0
    # adiabatic-cooling channel active on the k-packet block
    has_adiabatic: bool = False


def _host(a) -> np.ndarray:
    """An (L, S) line table as a host f64 array (tensors are read back)."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def two_photon_inv_cdf(alpha, beta, gamma, n=256, n_grid=8192):
    """Inverse CDF of the energy-weighted two-photon spectral distribution.

    Nussbaumer & Schmutz (1984) Eq. 2 frequency-dependent decay rate over
    y = nu/nu0 in (0, 1):
        A(y) ~ y(1-y)[1 - (4y(1-y))^gamma] + alpha (y(1-y))^beta (4y(1-y))^gamma
    The Monte Carlo samples the EMISSIVITY (energy) distribution y*A(y) —
    indivisible energy packets conserve energy, so frequency must follow the
    energy spectrum, not the photon-number spectrum.  Returns (n,) values of
    y at uniform quantiles i/(n-1); the kernel linearly interpolates.
    """
    y = (np.arange(n_grid) + 0.5) / n_grid
    x = y * (1.0 - y)
    A = x * (1.0 - (4.0 * x) ** gamma) + alpha * x**beta * (4.0 * x) ** gamma
    w = np.clip(y * A, 0.0, None)
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    q = np.arange(n) / (n - 1.0)
    return np.interp(q, cdf, y)


def _state_space(atom: AtomData):
    """Map flat level ids -> state ids; returns (state_of_flat, n_states,
    i_states (C,), k_state)."""
    macro = atom.macro_atom
    M_bb = macro.n_macro_levels
    state_of_flat = -np.ones(atom.n_levels, dtype=np.int64)
    state_of_flat[macro.macro_flat_ids] = np.arange(M_bb)

    pi = atom.photo_ion
    # flat index lookup for next-ion ground levels
    key = {
        (int(z), int(i), int(k)): f
        for f, (z, i, k) in enumerate(
            zip(atom.level_z, atom.level_ion, atom.level_number)
        )
    }
    n_states = M_bb
    i_states = np.zeros(pi.n_continua, dtype=np.int64)
    for c in range(pi.n_continua):
        f = key[(int(pi.cont_z[c]), int(pi.cont_ion[c]) + 1, 0)]
        if state_of_flat[f] < 0:
            state_of_flat[f] = n_states
            n_states += 1
        i_states[c] = state_of_flat[f]
        # the bound level itself must be a state (it is, if it has lines;
        # append otherwise)
        fl = int(pi.level_flat_idx[c])
        if state_of_flat[fl] < 0:
            state_of_flat[fl] = n_states
            n_states += 1
    k_state = n_states
    n_states += 1
    return state_of_flat, n_states, i_states, k_state


def solve_continuum_macro_state(
    atom: AtomData,
    plasma_state,
    cont_state,
    j_blues,  # (L, S) array or tensor
    enable_two_photon: bool = False,
    enable_adiabatic_cooling: bool = False,
    time_explosion: float | None = None,
) -> ContinuumMacroState:
    """Assemble all channels, normalize per state, solve the absorbing chain.

    With ``enable_two_photon`` and two-photon data present, each two-photon
    transition whose upper level is a macro state gains a deactivation
    channel with probability A_2ph * h nu0 (rate x emitted energy, the Lucy
    convention shared by the other channels).  The reference defines the
    channel plumbing (transition_probabilities.py:343-359,
    MacroAtomTransitionType.TWO_PHOTON) but never feeds it — this completes
    the physics and the kernel samples the Nussbaumer & Schmutz (1984)
    spectral distribution at emission.
    """
    macro = atom.macro_atom
    pi = atom.photo_ion
    S = plasma_state.tau_sobolev.shape[1]
    state_of_flat, M, i_states, k_state = _state_space(atom)

    beta = _host(plasma_state.beta_sobolev)
    stim = _host(plasma_state.stimulated_emission_factor)
    j_blues = _host(j_blues)
    n_e = cont_state.electron_densities

    srcs, dests, probs, kinds, ids = [], [], [], [], []

    def add(src, dest, p, kind=-1, id_=-1):
        src = np.atleast_1d(np.asarray(src, dtype=np.int64))
        n = len(src)
        srcs.append(src)
        dests.append(np.broadcast_to(np.asarray(dest, np.int64), (n,)).copy())
        probs.append(np.atleast_2d(p) if p.ndim == 2 else p[None, :])
        kinds.append(np.broadcast_to(np.asarray(kind, np.int8), (n,)).copy())
        ids.append(np.broadcast_to(np.asarray(id_, np.int64), (n,)).copy())

    # ---------------- bound-bound block (reference macroatom_solver.py
    # line_transition_* with c_einstein scale)
    refs = macro.block_references
    block_of = np.repeat(np.arange(macro.n_macro_levels), np.diff(refs))
    line_idx = macro.transition_line_id
    p_bb = C_EINSTEIN * macro.coef[:, None] * beta[line_idx]
    up = macro.transition_type == MACRO_INTERNAL_UP
    p_bb[up] *= stim[line_idx[up]] * j_blues[line_idx[up]]
    emit_bb = macro.transition_type < 0
    bb_dest = np.where(emit_bb, -1, macro.destination_level_id).astype(
        np.int64
    )
    add(
        block_of,
        bb_dest,
        p_bb,
        kind=np.where(emit_bb, EMIT_LINE, -1).astype(np.int8),
        id_=np.where(emit_bb, line_idx, -1).astype(np.int64),
    )

    lvl_state = state_of_flat[pi.level_flat_idx]  # (C,)
    e_level = atom.level_energy[pi.level_flat_idx]  # (C,)
    e_ion = H * pi.nu_threshold  # (C,) energy diff bound-free

    # ---------------- photoionization internal: level -> i
    add(lvl_state, i_states, cont_state.gamma * e_level[:, None])
    # recombination internal: i -> level
    add(i_states, lvl_state, cont_state.alpha_sp * e_level[:, None])
    # recombination emission: i -> (bf emission)
    add(
        i_states,
        -1,
        cont_state.alpha_sp * e_ion[:, None],
        kind=EMIT_BF,
        id_=np.arange(pi.n_continua),
    )
    # collisional ionization internal: level -> i
    add(
        lvl_state,
        i_states,
        cont_state.coll_ion_coeff * n_e[None, :] * e_level[:, None],
    )
    # collisional recombination: i -> level, i -> k
    add(
        i_states,
        lvl_state,
        cont_state.coll_recomb_coeff * n_e[None, :] * e_level[:, None],
    )
    add(
        i_states,
        k_state,
        cont_state.coll_recomb_coeff * n_e[None, :] * e_ion[:, None],
    )

    # ---------------- collisional bound-bound channels
    lid = cont_state.coll_line_ids
    if len(lid):
        lo_state = state_of_flat[atom.line_lower_idx[lid]]
        up_state = state_of_flat[atom.line_upper_idx[lid]]
        e_lo = atom.level_energy[atom.line_lower_idx[lid]]
        de = H * atom.line_nu[lid]
        ne_row = n_e[None, :]
        # excitation internal (lower -> upper), weight E_lower
        add(lo_state, up_state, cont_state.coll_exc_coeff * ne_row
            * e_lo[:, None])
        # de-excitation internal (upper -> lower), weight E_lower
        add(up_state, lo_state, cont_state.coll_deexc_coeff * ne_row
            * e_lo[:, None])
        # de-excitation to k-packet, weight dE
        add(up_state, k_state, cont_state.coll_deexc_coeff * ne_row
            * de[:, None])

    # ---------------- two-photon decay deactivation (upper -> ground via
    # the two-photon continuum); probability = A_2ph * h nu0
    n_two_photon = 0
    if enable_two_photon and atom.two_photon is not None:
        tp = atom.two_photon
        key = {
            (int(z), int(i), int(k)): f
            for f, (z, i, k) in enumerate(
                zip(atom.level_z, atom.level_ion, atom.level_number)
            )
        }
        for t in range(len(tp.z)):
            fu = key.get((int(tp.z[t]), int(tp.ion[t]),
                          int(tp.level_upper[t])))
            if fu is None or state_of_flat[fu] < 0:
                continue
            p_tp = np.full((1, S), tp.A_ul[t] * H * tp.nu0[t])
            add(int(state_of_flat[fu]), -1, p_tp,
                kind=EMIT_TWO_PHOTON, id_=t)
            n_two_photon += 1

    # ---------------- k-packet cooling block
    add(k_state, -1, cont_state.ff_cool_rate[None, :].repeat(1, axis=0),
        kind=EMIT_FF, id_=-1)
    add(
        np.full(pi.n_continua, k_state),
        -1,
        cont_state.fb_cool_rate,
        kind=EMIT_BF,
        id_=np.arange(pi.n_continua),
    )
    if len(lid):
        add(np.full(len(lid), k_state), up_state,
            cont_state.coll_exc_cool_rate)
    add(np.full(pi.n_continua, k_state), i_states,
        cont_state.coll_ion_cool_rate)
    # adiabatic cooling channel: C_adiabatic = 3 n_e k_B T_e / t_exp
    # (reference iip_plasma/properties/continuum.py:1048-1062
    # _calculate_adiabatic_cooling; config flag
    # plasma.continuum_interaction.enable_adiabatic_cooling).  The packet
    # is destroyed on selection — its energy becomes expansion work.
    if enable_adiabatic_cooling:
        if time_explosion is None:
            raise ValueError(
                "enable_adiabatic_cooling requires time_explosion"
            )
        c_adia = (
            3.0 * n_e * K_B * cont_state.t_electrons / time_explosion
        )
        add(k_state, -1, c_adia[None, :], kind=EMIT_ADIABATIC, id_=-1)

    src = np.concatenate(srcs)
    dest = np.concatenate(dests)
    p = np.concatenate(probs, axis=0)  # (T, S)
    kind = np.concatenate(kinds)
    cid = np.concatenate(ids)

    # sort by source state (stable: keeps channel-group order within blocks)
    order = np.argsort(src, kind="stable")
    src, dest, p, kind, cid = (
        src[order], dest[order], p[order], kind[order], cid[order]
    )
    block_start = np.searchsorted(src, np.arange(M + 1)).astype(np.int64)

    # normalize per source state over ALL channels
    p = np.clip(p, 0.0, None)
    T = p.shape[0]
    excl = np.zeros((T + 1, S))
    np.cumsum(p, axis=0, out=excl[1:])
    tot = (excl[block_start[1:]] - excl[block_start[:-1]])  # (M, S)
    tblock = np.repeat(np.arange(M), np.diff(block_start))
    with np.errstate(divide="ignore", invalid="ignore"):
        p_norm = np.where(tot[tblock] > 0, p / tot[tblock], 0.0)

    # ---------------- absorbing Markov chain per shell
    # Q = internal part; B = (I - Q)^{-1} diag(1 - rowsum(Q))
    # (reference absorbing_markov_chain.py:96-133)
    internal = dest >= 0
    rows = src[internal]
    cols = dest[internal]
    p_int = p_norm[internal]  # (Ti, S)
    B = np.zeros((S, M, M))
    eye = np.eye(M)
    for s in range(S):
        Q = np.zeros((M, M))
        np.add.at(Q, (rows, cols), p_int[:, s])
        deact = 1.0 - Q.sum(axis=1)
        try:
            Bs = np.linalg.solve(eye - Q, np.diag(np.clip(deact, 0.0, None)))
        except np.linalg.LinAlgError:
            Bs = np.diag(np.clip(deact, 0.0, None))
        B[s] = np.clip(Bs, 0.0, None)
    # cumulative row-normalized
    row_tot = B.sum(axis=2, keepdims=True)
    cum_B = np.cumsum(
        np.where(row_tot > 0, B / row_tot, 1.0 / M), axis=2
    )
    cum_B[..., -1] = 1.0

    # ---------------- deactivation blocks (renormalized per state)
    dmask = ~internal
    d_src = src[dmask]
    d_p = p_norm[dmask]
    d_kind = kind[dmask]
    d_id = cid[dmask]
    # ensure every state has at least one entry (dummy ff) so the kernel's
    # clamped block search never reads another state's entry
    have = np.zeros(M, dtype=bool)
    have[d_src] = True
    missing = np.nonzero(~have)[0]
    if len(missing):
        d_src = np.concatenate([d_src, missing])
        d_p = np.concatenate([d_p, np.ones((len(missing), S))])
        d_kind = np.concatenate(
            [d_kind, np.full(len(missing), EMIT_FF, np.int8)]
        )
        d_id = np.concatenate([d_id, np.full(len(missing), -1)])
    order_d = np.argsort(d_src, kind="stable")
    d_src, d_p, d_kind, d_id = (
        d_src[order_d], d_p[order_d], d_kind[order_d], d_id[order_d]
    )
    d_start = np.searchsorted(d_src, np.arange(M + 1)).astype(np.int32)
    D = d_p.shape[0]
    dexcl = np.zeros((D + 1, S))
    np.cumsum(d_p, axis=0, out=dexcl[1:])
    d_tot = dexcl[d_start[1:]] - dexcl[d_start[:-1]]
    dblock = np.repeat(np.arange(M), np.diff(d_start))
    with np.errstate(divide="ignore", invalid="ignore"):
        d_cum = np.where(
            d_tot[dblock] > 0,
            (dexcl[1:] - dexcl[d_start[:-1]][dblock]) / d_tot[dblock],
            1.0,
        )
    d_cum = np.clip(d_cum, 0.0, 1.0)
    d_cum[d_start[1:] - 1] = 1.0

    line2state = macro.line2macro_level_upper.astype(np.int32)

    return ContinuumMacroState(
        n_states=M,
        cum_B=cum_B.astype(np.float32),
        deact_block_start=d_start,
        deact_cum_prob=d_cum.astype(np.float32),
        deact_kind=d_kind.astype(np.int8),
        deact_id=d_id.astype(np.int32),
        line2state=line2state,
        photo_ion_state=i_states.astype(np.int32),
        k_state=int(k_state),
        n_two_photon=n_two_photon,
        has_adiabatic=enable_adiabatic_cooling,
    )
