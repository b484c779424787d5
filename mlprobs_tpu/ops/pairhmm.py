"""Pair-HMM forward/backward/posterior as batched JAX row-scans.

Implements both posterior models of the reference base aligner
(baseMSA ProbabilisticModel.h):

* 5-state double-affine pair-HMM (`hmm5_*`) — states M, X1, Y1, X2, Y2;
  fwd: ProbabilisticModel.h:153-274, bwd: :292-395, total: :405-454,
  posterior: :464-493.
* 3-state local pair-HMM with flanking random states (`local_*`) — the
  odds-ratio formulation where all emissions are divided by the random
  background; same file, `flag=false` branches.

Row-scan formulation: a `lax.scan` over rows carries the previous row of every
state.  States consuming x depend only on the previous row (element-wise);
states consuming y satisfy a first-order affine recurrence within the row,
resolved in O(log L) with an associative scan (see ops/semiring.py).
Sequences are padded to static shapes; `lx`/`ly` are dynamic lengths, and
the backward pass masks any contribution that would consume a padded
position, so no rolling/copying of buffers is needed.

All functions operate on a single pair; batch with
`jax.vmap(..., in_axes=(0, 0, 0, 0, None))`.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from mlprobs_tpu.ops.semiring import (
    LOG_ZERO,
    affine_scan_log,
    shift_left,
    shift_right,
)


def _lse(*terms):
    out = terms[0]
    for t in terms[1:]:
        out = jnp.logaddexp(out, t)
    return out


def _match_rows(x, y, lmatch):
    """(Lx, Ly+1) log match emissions; row i-1, position j = match(x_i, y_j).

    Position 0 of each row is LOG_ZERO (the j=0 grid column emits nothing).
    """
    m = lmatch[x[:, None], y[None, :]]
    pad = jnp.full((x.shape[0], 1), LOG_ZERO, m.dtype)
    return jnp.concatenate([pad, m], axis=1)


# --------------------------------------------------------------------------
# 5-state double-affine model
# --------------------------------------------------------------------------


def hmm5_forward(x, y, lx, ly, p):
    """Forward pass.  Returns (fM plane (Lx+1,Ly+1), states_at_ly (Lx+1,5)).

    states_at_ly[i] holds the five forward values at grid cell (i, ly);
    row `lx` of it gives the terminal cell for the total probability.
    """
    Lx, Ly = x.shape[0], y.shape[0]
    t, init = p["trans"], p["init"]
    match = _match_rows(x, y, p["lmatch"])          # (Lx, Ly+1)
    insx = p["lins"][x]                             # (Lx, 2)
    insy = p["lins"][y]                             # (Ly, 2)
    # ins emission of y_j at row position j (position 0 unused)
    insy_row = jnp.concatenate(
        [jnp.full((1, 2), LOG_ZERO), insy], axis=0
    )                                               # (Ly+1, 2)
    jidx = jnp.arange(Ly + 1)

    # row 0: only Y states are reachable (injections at (0,1))
    zero_row = jnp.full(Ly + 1, LOG_ZERO)

    def y0_row(k):
        c = jnp.where(jidx == 1, init[2 * k + 2] + insy_row[:, k], LOG_ZERO)
        d = insy_row[:, k] + t[2 * k + 2, 2 * k + 2]
        u = affine_scan_log(c[1:], d[1:])
        return jnp.concatenate([zero_row[:1], u])

    carry0 = (zero_row, zero_row, y0_row(0), zero_row, y0_row(1))
    row0_states = jnp.stack([r[ly] for r in carry0])

    def step(carry, i):
        pM, pX1, pY1, pX2, pY2 = carry
        mrow = match[i - 1]
        ix = insx[i - 1]

        # M: from all 5 states at (i-1, j-1), plus the (1,1) start injection
        rec = _lse(
            shift_right(pM) + t[0, 0],
            shift_right(pX1) + t[1, 0],
            shift_right(pY1) + t[2, 0],
            shift_right(pX2) + t[3, 0],
            shift_right(pY2) + t[4, 0],
        )
        inj_m = jnp.where((i == 1) & (jidx == 1), init[0], LOG_ZERO)
        M = mrow + jnp.logaddexp(rec, inj_m)

        # X states: element-wise from previous row, injection at (1,0)
        def x_state(k, pXk):
            inj = jnp.where((i == 1) & (jidx == 0), init[2 * k + 1], LOG_ZERO)
            return ix[k] + _lse(
                pM + t[0, 2 * k + 1], pXk + t[2 * k + 1, 2 * k + 1], inj
            )

        X1 = x_state(0, pX1)
        X2 = x_state(1, pX2)

        # Y states: within-row affine recurrence (from M at (i, j-1))
        Mshift = shift_right(M)

        def y_state(k):
            c = insy_row[:, k] + t[0, 2 * k + 2] + Mshift
            d = insy_row[:, k] + t[2 * k + 2, 2 * k + 2]
            u = affine_scan_log(c[1:], d[1:])
            return jnp.concatenate([zero_row[:1], u])

        Y1 = y_state(0)
        Y2 = y_state(1)

        carry = (M, X1, Y1, X2, Y2)
        states_at_ly = jnp.stack([r[ly] for r in carry])
        return carry, (M, states_at_ly)

    _, (m_rows, s_rows) = jax.lax.scan(
        step, carry0, jnp.arange(1, Lx + 1)
    )
    fM = jnp.concatenate([zero_row[None, :], m_rows], axis=0)
    states = jnp.concatenate([row0_states[None, :], s_rows], axis=0)
    return fM, states


def hmm5_backward(x, y, lx, ly, p):
    """Backward pass.  Returns (bM plane, start_cells (Lx+1, 4)).

    start_cells[i] = [bX1(i,0), bX2(i,0), bY1(i,1), bY2(i,1)]; rows 1 and 0
    give the values needed for the backward total probability.
    """
    Lx, Ly = x.shape[0], y.shape[0]
    t, init = p["trans"], p["init"]
    # chars at position i+1 / j+1 (grid-indexed); pad with unknown class
    xn = jnp.concatenate([x, jnp.full(1, 20, x.dtype)])
    yn = jnp.concatenate([y, jnp.full(1, 20, y.dtype)])
    # match(i+1, j+1) laid out at (row i, pos j)
    match_next = p["lmatch"][xn[:, None], yn[None, :]]   # (Lx+1, Ly+1)
    insx_next = p["lins"][xn]                            # (Lx+1, 2)
    insy_next = p["lins"][yn]                            # (Ly+1, 2)
    jidx = jnp.arange(Ly + 1)
    yvalid = jidx < ly            # consuming y at j+1 is allowed
    zero_row = jnp.full(Ly + 1, LOG_ZERO)

    def masked(term, ok):
        return jnp.where(ok, term, LOG_ZERO)

    def step(carry, i):
        nM, nX1, nY1, nX2, nY2 = carry   # rows at i+1 (garbage when i==Lx)
        xvalid = i < lx                   # consuming x at i+1 is allowed
        at_terminal = i == lx
        inj = jnp.where(at_terminal & (jidx == ly), 0.0, LOG_ZERO)

        # match contribution base: match(i+1, j+1) + bM(i+1, j+1)
        mterm = masked(
            match_next[i] + shift_left(nM), xvalid & yvalid
        )

        # Y states first: within-row right-to-left affine recurrence
        def y_state(k, dummy=None):
            c = jnp.logaddexp(mterm + t[2 * k + 2, 0], inj + init[2 * k + 2])
            d = masked(insy_next[:, k] + t[2 * k + 2, 2 * k + 2], yvalid)
            return affine_scan_log(c, d, reverse=True)

        Y1 = y_state(0)
        Y2 = y_state(1)

        def x_state(k, nXk):
            return _lse(
                mterm + t[2 * k + 1, 0],
                masked(insx_next[i, k] + nXk + t[2 * k + 1, 2 * k + 1],
                       xvalid),
                inj + init[2 * k + 1],
            )

        X1 = x_state(0, nX1)
        X2 = x_state(1, nX2)

        M = _lse(
            mterm + t[0, 0],
            masked(insx_next[i, 0] + nX1 + t[0, 1], xvalid),
            masked(insx_next[i, 1] + nX2 + t[0, 3], xvalid),
            masked(insy_next[:, 0] + shift_left(Y1) + t[0, 2], yvalid),
            masked(insy_next[:, 1] + shift_left(Y2) + t[0, 4], yvalid),
            inj + init[0],
        )

        carry = (M, X1, Y1, X2, Y2)
        start = jnp.stack([X1[0], X2[0], Y1[1], Y2[1]])
        return carry, (M, start)

    carry0 = (zero_row,) * 5
    _, (m_rows, s_rows) = jax.lax.scan(
        step, carry0, jnp.arange(Lx, -1, -1)
    )
    bM = m_rows[::-1]
    starts = s_rows[::-1]
    return bM, starts


def hmm5_posterior(x, y, lx, ly, p):
    """Match posterior plane, 0-based: out[i-1, j-1] = P(x_i ~ y_j).

    Shape (Lx, Ly); cells outside (lx, ly) are zero.
    """
    Lx, Ly = x.shape[0], y.shape[0]
    fM, fstates = hmm5_forward(x, y, lx, ly, p)
    bM, bstarts = hmm5_backward(x, y, lx, ly, p)

    init = p["init"]
    total_f = jax.scipy.special.logsumexp(fstates[lx] + init)
    # backward total: paths re-assembled at the three start cells
    m11 = p["lmatch"][x[0], y[0]]
    total_b = _lse(
        bM[1, 1] + init[0] + m11,
        bstarts[1, 0] + init[1] + p["lins"][x[0], 0],
        bstarts[1, 1] + init[3] + p["lins"][x[0], 1],
        bstarts[0, 2] + init[2] + p["lins"][y[0], 0],
        bstarts[0, 3] + init[4] + p["lins"][y[0], 1],
    )
    total = 0.5 * (total_f + total_b)

    post = jnp.exp(jnp.minimum(0.0, fM + bM - total))[1:, 1:]
    ivalid = jnp.arange(Lx)[:, None] < lx
    jvalid = jnp.arange(Ly)[None, :] < ly
    return jnp.where(ivalid & jvalid, post, 0.0)


# --------------------------------------------------------------------------
# 3-state local model (odds-ratio form)
# --------------------------------------------------------------------------


def _local_tables(x, y, p):
    """Odds-ratio match emissions mp'(i,j) = match - ins_x - ins_y."""
    mp = p["lmatch"][x[:, None], y[None, :]]
    mp = mp - p["lins"][x][:, None] - p["lins"][y][None, :]
    pad = jnp.full((x.shape[0], 1), LOG_ZERO, mp.dtype)
    return jnp.concatenate([pad, mp], axis=1)        # (Lx, Ly+1)


def local_forward(x, y, lx, ly, p):
    """Forward pass of the local model.  Returns (fM plane, total_f)."""
    Lx, Ly = x.shape[0], y.shape[0]
    lt, rt1 = p["trans"], p["log_stay"]
    mrows = _local_tables(x, y, p)
    jidx = jnp.arange(Ly + 1)
    zero_row = jnp.full(Ly + 1, LOG_ZERO)
    jvalid = (jidx >= 1) & (jidx <= ly)

    def step(carry, i):
        pM, pX, pY, tot = carry
        mrow = mrows[i - 1]
        # M: start-anywhere term plus transitions from (i-1, j-1)
        rec = _lse(
            shift_right(pM) + lt[0, 0],
            shift_right(pX) + lt[1, 0],
            shift_right(pY) + lt[2, 0],
        )
        M = mrow - 2 * rt1 + jnp.logaddexp(0.0, rec)
        M = jnp.where(jidx >= 1, M, LOG_ZERO)
        X = jnp.logaddexp(pM + lt[0, 1] - rt1, pX + lt[1, 1] - rt1)
        # Y within-row recurrence
        Mshift = shift_right(M)
        c = Mshift + lt[0, 2] - rt1
        d = jnp.full_like(c, lt[2, 2] - rt1)
        Y = jnp.concatenate(
            [zero_row[:1], affine_scan_log(c[1:], d[1:])]
        )
        tot = jnp.logaddexp(
            tot,
            jax.scipy.special.logsumexp(
                jnp.where(jvalid & (i <= lx), M, LOG_ZERO)
            ),
        )
        return (M, X, Y, tot), M

    (_, _, _, total_f), m_rows = jax.lax.scan(
        step, (zero_row, zero_row, zero_row, LOG_ZERO), jnp.arange(1, Lx + 1)
    )
    fM = jnp.concatenate([zero_row[None, :], m_rows], axis=0)
    return fM, total_f


def local_backward(x, y, lx, ly, p):
    """Backward pass of the local model.  Returns (bM plane, total_b)."""
    Lx, Ly = x.shape[0], y.shape[0]
    lt, rt1 = p["trans"], p["log_stay"]
    xn = jnp.concatenate([x, jnp.full(1, 20, x.dtype)])
    yn = jnp.concatenate([y, jnp.full(1, 20, y.dtype)])
    mp_next = (
        p["lmatch"][xn[:, None], yn[None, :]]
        - p["lins"][xn][:, None]
        - p["lins"][yn][None, :]
    )                                                # (Lx+1, Ly+1)
    # odds-ratio emission at the cell itself, for the total
    mp_here = _local_tables(x, y, p)                 # (Lx, Ly+1)
    jidx = jnp.arange(Ly + 1)
    yvalid = jidx < ly
    hvalid = (jidx >= 1) & (jidx <= ly)
    zero_row = jnp.full(Ly + 1, LOG_ZERO)

    def masked(term, ok):
        return jnp.where(ok, term, LOG_ZERO)

    def step(carry, i):
        nM, nX, nY, tot = carry
        xvalid = i < lx
        mterm = masked(mp_next[i] + shift_left(nM), xvalid & yvalid)

        c = mterm + lt[2, 0] - 2 * rt1
        d = masked(jnp.full_like(c, lt[2, 2] - rt1), yvalid)
        Y = affine_scan_log(c, d, reverse=True)

        X = jnp.logaddexp(
            mterm + lt[1, 0] - 2 * rt1,
            masked(nX + lt[1, 1] - rt1, xvalid),
        )
        M = _lse(
            jnp.zeros_like(mterm),                    # end anywhere
            mterm + lt[0, 0] - 2 * rt1,
            masked(nX + lt[0, 1] - rt1, xvalid),
            masked(shift_left(Y) + lt[0, 2] - rt1, yvalid),
        )
        # total_b term: bM(i,j) + mp'(i,j) - 2*rt1 over valid cells
        mp_row = mp_here[jnp.maximum(i - 1, 0)]
        tot = jnp.logaddexp(
            tot,
            jax.scipy.special.logsumexp(
                jnp.where(
                    hvalid & (i >= 1) & (i <= lx),
                    M + mp_row - 2 * rt1,
                    LOG_ZERO,
                )
            ),
        )
        return (M, X, Y, tot), M

    (_, _, _, total_b), m_rows = jax.lax.scan(
        step, (zero_row, zero_row, zero_row, LOG_ZERO),
        jnp.arange(Lx, -1, -1),
    )
    bM = m_rows[::-1]
    return bM, total_b


def local_posterior(x, y, lx, ly, p):
    """Match posterior of the local model, 0-based (Lx, Ly) plane."""
    Lx, Ly = x.shape[0], y.shape[0]
    fM, total_f = local_forward(x, y, lx, ly, p)
    bM, total_b = local_backward(x, y, lx, ly, p)
    total = 0.5 * (total_f + total_b)
    post = jnp.exp(jnp.minimum(0.0, fM + bM - total))[1:, 1:]
    ivalid = jnp.arange(Lx)[:, None] < lx
    jvalid = jnp.arange(Ly)[None, :] < ly
    return jnp.where(ivalid & jvalid, post, 0.0)
