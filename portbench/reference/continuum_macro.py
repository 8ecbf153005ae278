"""The continuum macro atom of the Type IIP workflow as an absorbing Markov
chain: host numpy, f64, per iteration.

Written from TARDIS's ContinuumMacroAtomSolver and create_absorbing_probs
(tardis/opacities/macro_atom/), in the form both of the repository's
packages take, and kept here frozen.  States are the macro levels, the
i-packet states (the ground level of each continuum's next ion) and one
k-packet.  Every channel is a rate times an energy (the bound-bound
coefficients times c_einstein): bound-bound radiative, photoionization
and recombination, collisional ionization, recombination, excitation and
de-excitation, and the k-packet's cooling (free-free, free-bound,
collisional).  Per shell, the internal part Q folds into the absorbing
probabilities B = (I - Q)^-1 diag(1 - rowsum Q); the deactivation
channels of each state form a cumulative block with an emission kind.
The benchmark's configuration enables neither the two-photon nor the
adiabatic channel.
"""

from dataclasses import dataclass

import numpy as np

from portbench.reference.atoms import INTERNAL_UP
from portbench.reference.constants import C, E_CHARGE, H, M_E

C_EINSTEIN = float(4.0 * (np.pi * E_CHARGE) ** 2 / (C * M_E))
EMIT_LINE, EMIT_BF, EMIT_FF = 0, 1, 2


@dataclass
class Macro:
    n_states: int
    cum_B: np.ndarray  # (S, M, M) f32 cumulative absorbing rows
    deact_block_start: np.ndarray  # (M + 1,)
    deact_cum_prob: np.ndarray  # (D, S) f32
    deact_kind: np.ndarray  # (D,)
    deact_id: np.ndarray  # (D,) line or continuum id
    line2state: np.ndarray  # (L,)
    photo_ion_state: np.ndarray  # (C,)
    k_state: int


def state_space(atoms):
    """(state of each level, states, i-packet state of each continuum,
    k-packet state)."""
    M_bb = atoms.n_macro
    state_of = -np.ones(len(atoms.level_energy), dtype=np.int64)
    state_of[atoms.macro_levels] = np.arange(M_bb)
    pi = atoms.photo_ion
    key = {(int(z), int(i), int(k)): f for f, (z, i, k) in enumerate(
        zip(atoms.level_z, atoms.level_ion, atoms.level_number))}
    n = M_bb
    i_states = np.zeros(len(pi["cont_z"]), dtype=np.int64)
    for c in range(len(pi["cont_z"])):
        f = key[(int(pi["cont_z"][c]), int(pi["cont_ion"][c]) + 1, 0)]
        if state_of[f] < 0:
            state_of[f] = n
            n += 1
        i_states[c] = state_of[f]
        fl = int(pi["level"][c])
        if state_of[fl] < 0:
            state_of[fl] = n
            n += 1
    return state_of, n + 1, i_states, n


def solve_macro(atoms, cs, beta, stim, j_blues) -> Macro:
    """``cs``: the continuum state; ``beta``, ``stim``, ``j_blues``: the
    (L, S) line tables as host f64 arrays."""
    pi = atoms.photo_ion
    S = beta.shape[1]
    state_of, M, i_states, k_state = state_space(atoms)
    n_e = cs.electron_densities
    srcs, dests, probs, kinds, ids = [], [], [], [], []

    def add(src, dest, p, kind=-1, id_=-1):
        src = np.atleast_1d(np.asarray(src, dtype=np.int64))
        n = len(src)
        srcs.append(src)
        dests.append(np.broadcast_to(np.asarray(dest, np.int64), (n,)).copy())
        probs.append(np.atleast_2d(p) if p.ndim == 2 else p[None, :])
        kinds.append(np.broadcast_to(np.asarray(kind, np.int8), (n,)).copy())
        ids.append(np.broadcast_to(np.asarray(id_, np.int64), (n,)).copy())

    line_idx = atoms.m_line
    p_bb = C_EINSTEIN * atoms.m_coef[:, None] * beta[line_idx]
    up = atoms.m_type == INTERNAL_UP
    p_bb[up] *= stim[line_idx[up]] * j_blues[line_idx[up]]
    emit_bb = atoms.m_type < 0
    add(atoms.m_src, np.where(emit_bb, -1, atoms.m_dest).astype(np.int64),
        p_bb, kind=np.where(emit_bb, EMIT_LINE, -1).astype(np.int8),
        id_=np.where(emit_bb, line_idx, -1).astype(np.int64))

    lvl_state = state_of[pi["level"]]
    e_level = atoms.level_energy[pi["level"]]
    e_ion = H * pi["nu"][pi["block_references"][:-1]]
    n_c = len(pi["cont_z"])
    add(lvl_state, i_states, cs.gamma * e_level[:, None])
    add(i_states, lvl_state, cs.alpha_sp * e_level[:, None])
    add(i_states, -1, cs.alpha_sp * e_ion[:, None], kind=EMIT_BF,
        id_=np.arange(n_c))
    add(lvl_state, i_states, cs.coll_ion_coeff * n_e[None, :]
        * e_level[:, None])
    add(i_states, lvl_state, cs.coll_recomb_coeff * n_e[None, :]
        * e_level[:, None])
    add(i_states, k_state, cs.coll_recomb_coeff * n_e[None, :]
        * e_ion[:, None])
    lid = cs.coll_line_ids
    if len(lid):
        lo_state = state_of[atoms.line_lower[lid]]
        up_state = state_of[atoms.line_upper[lid]]
        e_lo = atoms.level_energy[atoms.line_lower[lid]]
        de = H * atoms.line_nu[lid]
        ne_row = n_e[None, :]
        add(lo_state, up_state, cs.coll_exc_coeff * ne_row * e_lo[:, None])
        add(up_state, lo_state, cs.coll_deexc_coeff * ne_row * e_lo[:, None])
        add(up_state, k_state, cs.coll_deexc_coeff * ne_row * de[:, None])
    add(k_state, -1, cs.ff_cool_rate[None, :].repeat(1, axis=0),
        kind=EMIT_FF, id_=-1)
    add(np.full(n_c, k_state), -1, cs.fb_cool_rate, kind=EMIT_BF,
        id_=np.arange(n_c))
    if len(lid):
        add(np.full(len(lid), k_state), up_state, cs.coll_exc_cool_rate)
    add(np.full(n_c, k_state), i_states, cs.coll_ion_cool_rate)

    src = np.concatenate(srcs)
    dest = np.concatenate(dests)
    p = np.concatenate(probs, axis=0)
    kind = np.concatenate(kinds)
    cid = np.concatenate(ids)
    order = np.argsort(src, kind="stable")
    src, dest, p, kind, cid = (src[order], dest[order], p[order],
                               kind[order], cid[order])
    block_start = np.searchsorted(src, np.arange(M + 1)).astype(np.int64)
    p = np.clip(p, 0.0, None)
    T = p.shape[0]
    excl = np.zeros((T + 1, S))
    np.cumsum(p, axis=0, out=excl[1:])
    tot = excl[block_start[1:]] - excl[block_start[:-1]]
    tblock = np.repeat(np.arange(M), np.diff(block_start))
    with np.errstate(divide="ignore", invalid="ignore"):
        p_norm = np.where(tot[tblock] > 0, p / tot[tblock], 0.0)

    internal = dest >= 0
    rows, cols, p_int = src[internal], dest[internal], p_norm[internal]
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
    row_tot = B.sum(axis=2, keepdims=True)
    cum_B = np.cumsum(np.where(row_tot > 0, B / row_tot, 1.0 / M), axis=2)
    cum_B[..., -1] = 1.0

    dmask = ~internal
    d_src, d_p, d_kind, d_id = (src[dmask], p_norm[dmask], kind[dmask],
                                cid[dmask])
    have = np.zeros(M, dtype=bool)
    have[d_src] = True
    missing = np.nonzero(~have)[0]
    if len(missing):
        d_src = np.concatenate([d_src, missing])
        d_p = np.concatenate([d_p, np.ones((len(missing), S))])
        d_kind = np.concatenate([d_kind, np.full(len(missing), EMIT_FF,
                                                 np.int8)])
        d_id = np.concatenate([d_id, np.full(len(missing), -1)])
    order_d = np.argsort(d_src, kind="stable")
    d_src, d_p, d_kind, d_id = (d_src[order_d], d_p[order_d],
                                d_kind[order_d], d_id[order_d])
    d_start = np.searchsorted(d_src, np.arange(M + 1)).astype(np.int32)
    D = d_p.shape[0]
    dexcl = np.zeros((D + 1, S))
    np.cumsum(d_p, axis=0, out=dexcl[1:])
    d_tot = dexcl[d_start[1:]] - dexcl[d_start[:-1]]
    dblock = np.repeat(np.arange(M), np.diff(d_start))
    with np.errstate(divide="ignore", invalid="ignore"):
        d_cum = np.where(d_tot[dblock] > 0,
                         (dexcl[1:] - dexcl[d_start[:-1]][dblock])
                         / d_tot[dblock], 1.0)
    d_cum = np.clip(d_cum, 0.0, 1.0)
    d_cum[d_start[1:] - 1] = 1.0
    return Macro(n_states=M, cum_B=cum_B.astype(np.float32),
                 deact_block_start=d_start,
                 deact_cum_prob=d_cum.astype(np.float32),
                 deact_kind=d_kind.astype(np.int8),
                 deact_id=d_id.astype(np.int32),
                 line2state=atoms.line_macro_upper.astype(np.int32),
                 photo_ion_state=i_states.astype(np.int32),
                 k_state=int(k_state))
