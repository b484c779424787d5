"""EM parameter re-estimation for the 5-state pair HMM.

Reference: ProbabilisticModel::ComputeNewParameters
(baseMSA/C_P_NP_Aln/ProbabilisticModel.h:586-788).  The reference ships
this for offline parameter training; the pipeline never calls it
(MSA.cpp uses fixed Defaults.h parameters), but it is part of the
library surface, so it gets a device form: full-state forward and
backward planes from one lax.scan each, expected transition /
initial-state / emission counts as vectorised log-sum-exp reductions
over the (Lx+1, Ly+1) grid, and the reference's exact normalisation
into new (init, gap_open, gap_extend, emit_pairs, emit_single).

State order matches models/params.hmm5_params: 0=M, 1=X1, 2=Y1, 3=X2,
4=Y2 with transition matrix p["trans"][from, to].
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from mlprobs_tpu.ops.pairhmm import _lse
from mlprobs_tpu.ops.semiring import (
    LOG_ZERO, affine_scan_log, shift_left, shift_right,
)


def _full_forward(x, y, p):
    """All-state forward planes: (5, Lx+1, Ly+1) log values."""
    Lx, Ly = x.shape[0], y.shape[0]
    t, init = p["trans"], p["init"]
    lmatch, lins = p["lmatch"], p["lins"]
    match = lmatch[x[:, None], y[None, :]]
    insx = lins[x]
    insy_row = jnp.concatenate(
        [jnp.full((1, 2), LOG_ZERO), lins[y]], axis=0
    )
    jidx = jnp.arange(Ly + 1)
    zero_row = jnp.full(Ly + 1, LOG_ZERO)

    def y0_row(k):
        c = jnp.where(jidx == 1, init[2 * k + 2] + insy_row[:, k],
                      LOG_ZERO)
        d = insy_row[:, k] + t[2 * k + 2, 2 * k + 2]
        u = affine_scan_log(c[1:], d[1:])
        return jnp.concatenate([zero_row[:1], u])

    carry0 = (zero_row, zero_row, y0_row(0), zero_row, y0_row(1))

    def step(carry, i):
        pM, pX1, pY1, pX2, pY2 = carry
        mrow = jnp.concatenate(
            [jnp.full(1, LOG_ZERO), match[i - 1]]
        )
        ix = insx[i - 1]
        rec = _lse(
            shift_right(pM) + t[0, 0],
            shift_right(pX1) + t[1, 0],
            shift_right(pY1) + t[2, 0],
            shift_right(pX2) + t[3, 0],
            shift_right(pY2) + t[4, 0],
        )
        inj_m = jnp.where((i == 1) & (jidx == 1), init[0], LOG_ZERO)
        M = mrow + jnp.logaddexp(rec, inj_m)

        def x_state(k, pXk):
            inj = jnp.where((i == 1) & (jidx == 0),
                            init[2 * k + 1], LOG_ZERO)
            return ix[k] + _lse(
                pM + t[0, 2 * k + 1],
                pXk + t[2 * k + 1, 2 * k + 1], inj
            )

        X1, X2 = x_state(0, pX1), x_state(1, pX2)
        Mshift = shift_right(M)

        def y_state(k):
            c = insy_row[:, k] + t[0, 2 * k + 2] + Mshift
            d = insy_row[:, k] + t[2 * k + 2, 2 * k + 2]
            u = affine_scan_log(c[1:], d[1:])
            return jnp.concatenate([zero_row[:1], u])

        carry = (M, X1, y_state(0), X2, y_state(1))
        return carry, jnp.stack(carry)

    _, rows = jax.lax.scan(step, carry0, jnp.arange(1, Lx + 1))
    row0 = jnp.stack(carry0)
    return jnp.concatenate([row0[None], rows], axis=0).transpose(1, 0, 2)


def _full_backward(x, y, p):
    """All-state backward planes: (5, Lx+1, Ly+1) log values."""
    Lx, Ly = x.shape[0], y.shape[0]
    t, init = p["trans"], p["init"]
    xn = jnp.concatenate([x, jnp.full(1, 20, x.dtype)])
    yn = jnp.concatenate([y, jnp.full(1, 20, y.dtype)])
    match_next = p["lmatch"][xn[:, None], yn[None, :]]
    insx_next = p["lins"][xn]
    insy_next = p["lins"][yn]
    jidx = jnp.arange(Ly + 1)
    yvalid = jidx < Ly
    zero_row = jnp.full(Ly + 1, LOG_ZERO)

    def masked(term, ok):
        return jnp.where(ok, term, LOG_ZERO)

    def step(carry, i):
        nM, nX1, nY1, nX2, nY2 = carry
        xvalid = i < Lx
        at_term = i == Lx
        inj = jnp.where(at_term & (jidx == Ly), 0.0, LOG_ZERO)
        mterm = masked(match_next[i] + shift_left(nM), xvalid & yvalid)

        def y_state(k):
            c = jnp.logaddexp(mterm + t[2 * k + 2, 0],
                              inj + init[2 * k + 2])
            d = masked(
                insy_next[:, k] + t[2 * k + 2, 2 * k + 2], yvalid
            )
            return affine_scan_log(c, d, reverse=True)

        Y1, Y2 = y_state(0), y_state(1)

        def x_state(k, nXk):
            return _lse(
                mterm + t[2 * k + 1, 0],
                masked(
                    insx_next[i, k] + nXk + t[2 * k + 1, 2 * k + 1],
                    xvalid,
                ),
                inj + init[2 * k + 1],
            )

        X1, X2 = x_state(0, nX1), x_state(1, nX2)
        M = _lse(
            mterm + t[0, 0],
            masked(insx_next[i, 0] + nX1 + t[0, 1], xvalid),
            masked(insx_next[i, 1] + nX2 + t[0, 3], xvalid),
            masked(insy_next[:, 0] + shift_left(Y1) + t[0, 2], yvalid),
            masked(insy_next[:, 1] + shift_left(Y2) + t[0, 4], yvalid),
            inj + init[0],
        )
        carry = (M, X1, Y1, X2, Y2)
        return carry, jnp.stack(carry)

    carry0 = (zero_row,) * 5
    _, rows = jax.lax.scan(step, carry0, jnp.arange(Lx, -1, -1))
    return rows[::-1].transpose(1, 0, 2)


def hmm5_em_step(x, y, p, train_emissions: bool = False):
    """One EM re-estimation from a single pair (x, y), full lengths.

    Returns dict with "init" (5,), "gap_open" (4,), "gap_extend" (4,)
    and, when train_emissions, "emit_pairs" (21, 21) / "emit_single"
    (21,) — the same normalised quantities ComputeNewParameters writes
    into initDistribMat/gapOpen/gapExtend/emitPairs/emitSingle."""
    Lx, Ly = x.shape[0], y.shape[0]
    t, init = p["trans"], p["init"]
    f = _full_forward(x, y, p)     # (5, Lx+1, Ly+1)
    b = _full_backward(x, y, p)
    total = jax.scipy.special.logsumexp(f[:, Lx, Ly] + init)

    match = p["lmatch"][x[:, None], y[None, :]]       # (Lx, Ly)
    insx = p["lins"][x]                                # (Lx, 2)
    insy = p["lins"][y]                                # (Ly, 2)

    # init counts: f+b at the entry cells plus the terminal cell
    # (ProbabilisticModel.h:621-635)
    fb = f + b
    init_counts = jnp.stack([
        jnp.logaddexp(fb[0, 1, 1], fb[0, Lx, Ly]),
        jnp.logaddexp(fb[1, 1, 0], fb[1, Lx, Ly]),
        jnp.logaddexp(fb[2, 0, 1], fb[2, Lx, Ly]),
        jnp.logaddexp(fb[3, 1, 0], fb[3, Lx, Ly]),
        jnp.logaddexp(fb[4, 0, 1], fb[4, Lx, Ly]),
    ]) - total

    # transitions into M: f_k(i-1, j-1) + t[k,0] + match(i,j) + bM(i,j)
    mcell = match + b[0, 1:, 1:]                       # (Lx, Ly)
    t_k0 = jnp.stack([
        jax.scipy.special.logsumexp(
            f[k, :Lx, :Ly] + t[k, 0] + mcell
        )
        for k in range(5)
    ]) - total

    # gap transitions 0->2k+1 / (2k+1)->(2k+1) (x inserts), same for y
    def gap_counts(k):
        ex = insx[:, k]                                # emit x_i
        open_x = jax.scipy.special.logsumexp(
            f[0, :Lx, :] + t[0, 2 * k + 1]
            + ex[:, None] + b[2 * k + 1, 1:, :]
        )
        ext_x = jax.scipy.special.logsumexp(
            f[2 * k + 1, :Lx, :] + t[2 * k + 1, 2 * k + 1]
            + ex[:, None] + b[2 * k + 1, 1:, :]
        )
        ey = insy[:, k]
        open_y = jax.scipy.special.logsumexp(
            f[0, :, :Ly] + t[0, 2 * k + 2]
            + ey[None, :] + b[2 * k + 2, :, 1:]
        )
        ext_y = jax.scipy.special.logsumexp(
            f[2 * k + 2, :, :Ly] + t[2 * k + 2, 2 * k + 2]
            + ey[None, :] + b[2 * k + 2, :, 1:]
        )
        return open_x - total, ext_x - total, open_y - total, \
            ext_y - total

    # new initial distribution (should sum to ~2 before normalising)
    tot_init = jnp.sum(jnp.exp(init_counts))
    new_init = jnp.empty(5)
    new_init = new_init.at[0].set(
        jnp.clip(jnp.exp(init_counts[0]) / tot_init, 0.0, 1.0)
    )
    for k in range(2):
        val = 0.5 * (jnp.exp(init_counts[2 * k + 1])
                     + jnp.exp(init_counts[2 * k + 2]))
        new_init = new_init.at[2 * k + 1].set(
            jnp.clip(val / tot_init, 0.0, 1.0)
        )
        new_init = new_init.at[2 * k + 2].set(
            jnp.clip(val / tot_init, 0.0, 1.0)
        )

    gaps = [gap_counts(k) for k in range(2)]
    in_match = jnp.exp(t_k0[0]) + sum(
        jnp.exp(g[0]) + jnp.exp(g[2]) for g in gaps
    )
    gap_open = jnp.empty(4)
    gap_extend = jnp.empty(4)
    for k, (ox_, ex_, oy_, ey_) in enumerate(gaps):
        in_gap = (
            jnp.exp(t_k0[2 * k + 1]) + jnp.exp(ex_)
            + jnp.exp(t_k0[2 * k + 2]) + jnp.exp(ey_)
        )
        go = (jnp.exp(ox_) + jnp.exp(oy_)) / (2.0 * in_match)
        ge = (jnp.exp(ex_) + jnp.exp(ey_)) / in_gap
        gap_open = gap_open.at[2 * k].set(go).at[2 * k + 1].set(go)
        gap_extend = gap_extend.at[2 * k].set(ge) \
                               .at[2 * k + 1].set(ge)

    out = {"init": new_init, "gap_open": gap_open,
           "gap_extend": gap_extend}

    if train_emissions:
        # pair emission posteriors at match cells; single emissions at
        # insert cells — scattered onto the 21-class alphabet
        post_m = jnp.exp(
            jnp.stack([
                f[k, :Lx, :Ly] + t[k, 0] + mcell for k in range(5)
            ]) - total
        ).sum(axis=0)                                   # (Lx, Ly)
        ohx = jax.nn.one_hot(x, 21)
        ohy = jax.nn.one_hot(y, 21)
        pair_counts = jnp.einsum("ij,ia,jb->ab", post_m, ohx, ohy)
        pair_counts = pair_counts + pair_counts.T       # symmetrised
        single = jnp.zeros(21)
        for k in range(2):
            px = jnp.exp(
                jnp.logaddexp(
                    jax.scipy.special.logsumexp(
                        f[0, :Lx, :] + t[0, 2 * k + 1]
                        + insx[:, k][:, None] + b[2 * k + 1, 1:, :],
                        axis=1,
                    ),
                    jax.scipy.special.logsumexp(
                        f[2 * k + 1, :Lx, :]
                        + t[2 * k + 1, 2 * k + 1]
                        + insx[:, k][:, None] + b[2 * k + 1, 1:, :],
                        axis=1,
                    ),
                ) - total
            )
            py = jnp.exp(
                jnp.logaddexp(
                    jax.scipy.special.logsumexp(
                        f[0, :, :Ly] + t[0, 2 * k + 2]
                        + insy[:, k][None, :] + b[2 * k + 2, :, 1:],
                        axis=0,
                    ),
                    jax.scipy.special.logsumexp(
                        f[2 * k + 2, :, :Ly]
                        + t[2 * k + 2, 2 * k + 2]
                        + insy[:, k][None, :] + b[2 * k + 2, :, 1:],
                        axis=0,
                    ),
                ) - total
            )
            single = single + ohx.T @ px + ohy.T @ py
        # reference normalises by the upper-triangle-plus-diagonal total
        # of the symmetrised count matrix (ProbabilisticModel.h:757-760)
        tot_pairs = 0.5 * (jnp.sum(pair_counts)
                           + jnp.sum(jnp.diag(pair_counts)))
        out["emit_pairs"] = pair_counts / jnp.maximum(tot_pairs, 1e-30)
        out["emit_single"] = single / jnp.maximum(
            jnp.sum(single), 1e-30
        )
    return out
