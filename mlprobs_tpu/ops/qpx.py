"""Reference-approximate QuickProbs HMM5 posterior ("qp-exact").

QuickProbs computes its 5-state pair-HMM forward/backward in float32
LOG space with POLYNOMIAL approximations: LOOKUP_FLOAT, a piecewise
cubic fit of log1p(exp(x)) on [0, 7.5] (ScoreType.h:185-212), inside
every LOG_ADD / LOG_PLUS_EQUALS, and a branch-polynomial EXP on
[-16, 0] for the posterior (ScoreType.h:40-60 active under
`typedef float ScoreType`).  The fit error (~1e-4..1e-3 per op) is
path-dependent, so an exact scaled-probability engine cannot reproduce
the binary's posteriors — and through the MWT/construction tie-breaks
the ~2e-3 posterior gap was the remaining source of output divergence
in the realigner role.  This module replays the reference arithmetic
operation-for-operation (same LOG_ADD orders, same guards, same
LOG_ZERO = -2e20 absorption) as vectorised anti-diagonal lax.scans.

Recurrence source: ParallelProbabilisticModel::computeForwardMatrix /
computeBackwardMatrix (ParallelProbabilisticModel.cpp:40-238),
posterior (ibid:240-273), called from PosteriorStage::computePairwise
(PosteriorStage.cpp:122-153).

Plane convention matches ops/wavefront.py: (D, B, W) with
D = 2*Lp + 1, W = Lp + 1, row d lane j = grid cell (i = d - j, j),
1-indexed residues.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

PAD = 20
LOG_ZERO = np.float32(-2e20)
THR = np.float32(7.5)  # LOG_UNDERFLOW_THRESHOLD


def _rounded(p, zero):
    """The f32 product `p`, rounded as an operation of its own.

    XLA:CPU contracts a multiply and the add that consumes it into one
    FMA (a single rounding); XLA:GPU rounds both, as the native qp
    engine does (mul<true> in native/mlprobs_native.cpp).  In log space
    a one-ulp difference at |value| ~ 1e3 moves a posterior by ~1e-4,
    so the product passes through an integer XOR with `zero`: an int32
    0 that the compiler cannot prove to be 0 (it is computed from the
    data), so it cannot fuse the product into the add, on any backend."""
    bits = jax.lax.bitcast_convert_type(p, jnp.int32) ^ zero
    return jax.lax.bitcast_convert_type(bits, jnp.float32)


def _horner(coeffs, x, zero):
    """((c0 * x + c1) * x + ...) + cn in f32, every product rounded."""
    acc = jnp.float32(coeffs[0])
    for c in coeffs[1:]:
        acc = _rounded(acc * x, zero) + jnp.float32(c)
    return acc


def lookup_float(x):
    """Piecewise-cubic log1p(exp(x)) on [0, 7.5] (LOOKUP_FLOAT)."""
    x = x.astype(jnp.float32)
    # x >= 0 (or -0.0): its bits are >= 0, so this is 0 (at -0.0 it
    # flips the sign of zero products only)
    zero = jnp.minimum(jax.lax.bitcast_convert_type(x, jnp.int32), 0)

    def h(*coeffs):
        return _horner(coeffs, x, zero)

    p1 = h(-0.009350833524763, 0.130659527668286,
           0.498799810682272, 0.693203116424741)
    p2 = h(-0.014532321752540, 0.139942324101744,
           0.495635523139337, 0.692140569840976)
    p3 = h(-0.004605031767994, 0.063427417320019,
           0.695956496475118, 0.514272634594009)
    p4 = h(-0.000458661602210, 0.009695946122598,
           0.930734667215156, 0.168037164329057)
    return jnp.where(
        x <= 1.0, p1,
        jnp.where(x <= 2.5, p2, jnp.where(x <= 4.5, p3, p4)),
    )


def log_add(x, y):
    """LOG_ADD(float, float) (ScoreType.h:269-276): approximate
    log-sum-exp with exact LOG_ZERO absorption and the 7.5 underflow
    threshold.  log_add(v, LOG_ZERO) == v exactly."""
    hi = jnp.maximum(x, y)
    lo = jnp.minimum(x, y)
    d = hi - lo
    return jnp.where(
        (lo == LOG_ZERO) | (d >= THR), hi, lookup_float(d) + lo
    )


def exp_ref(x):
    """Branch-polynomial EXP (ScoreType.h:40-60); exp(x) for x > 0,
    0 below -16."""
    x = x.astype(jnp.float32)
    # x <= 0 (the polynomials' domain): its bits are negative or 0
    # (+0.0), so this is 0
    zero = jnp.maximum(jax.lax.bitcast_convert_type(x, jnp.int32), 0)

    def p(*coeffs):
        return _horner(coeffs, x, zero)

    m05 = p(0.03254409303190190000, 0.16280432765779600000,
            0.49929760485974900000, 0.99995149601363700000,
            0.99999925508501600000)
    m1 = p(0.01973899026052090000, 0.13822379685007000000,
           0.48056651562365000000, 0.99326940370383500000,
           0.99906756856399500000)
    m2 = p(0.00940528203591384000, 0.09414963667859410000,
           0.40825793595877300000, 0.93933625499130400000,
           0.98369508190545300000)
    m4 = p(0.00217245711583303000, 0.03484829428350620000,
           0.22118199801337800000, 0.67049462206469500000,
           0.83556950223398500000)
    m8 = p(0.00012398771025456900, 0.00349155785951272000,
           0.03727721426017900000, 0.17974997741536900000,
           0.33249299994217400000)
    m16 = p(0.00000051741713416603, 0.00002721456879608080,
            0.00053418601865636800, 0.00464101989351936000,
            0.01507447981459420000)
    return jnp.where(
        x > 0, jnp.exp(x),
        jnp.where(x > -0.5, m05,
                  jnp.where(x > -1.0, m1,
                            jnp.where(x > -2.0, m2,
                                      jnp.where(x > -4.0, m4,
                                                jnp.where(x > -8.0, m8,
                                                          jnp.where(
                                                              x > -16.0,
                                                              m16, 0.0,
                                                          )))))))


def _skew_emissions(xp, yp, lmatch, lins):
    """Pre-skewed emission planes.

    em_match[d, b, j] = lmatch[x_{d-j}, y_j] (1-indexed; PAD outside),
    insx[k][d, b, j] = lins[x_{d-j}, k], insy[k][b, j] = lins[y_j, k].
    """
    b, lp = xp.shape
    W = lp + 1
    D = 2 * lp + 1
    xg = jnp.concatenate(
        [jnp.full((b, 1), PAD, xp.dtype), xp], axis=1
    ).astype(jnp.int32)                                  # x_i, i=0..lp
    yg = jnp.concatenate(
        [jnp.full((b, 1), PAD, yp.dtype), yp], axis=1
    ).astype(jnp.int32)
    d_idx = jnp.arange(D, dtype=jnp.int32)[:, None]      # (D, 1)
    j_idx = jnp.arange(W, dtype=jnp.int32)[None, :]      # (1, W)
    i_idx = jnp.clip(d_idx - j_idx, 0, lp)               # (D, W)
    xsk = xg[:, i_idx]                                   # (B, D, W)
    em_match = lmatch[xsk, yg[:, None, :]]               # (B, D, W)
    insx0 = lins[xsk, 0]
    insx1 = lins[xsk, 1]
    insy0 = lins[yg, 0]                                  # (B, W)
    insy1 = lins[yg, 1]
    return (
        jnp.moveaxis(em_match, 0, 1),                    # (D, B, W)
        jnp.moveaxis(insx0, 0, 1), jnp.moveaxis(insx1, 0, 1),
        insy0, insy1,
    )


def _shift1(v):
    """lane j -> value at lane j-1, LOG_ZERO into lane 0."""
    r = jnp.roll(v, 1, axis=-1)
    return r.at[..., 0].set(LOG_ZERO)


def _shiftm1(v):
    """lane j -> value at lane j+1, LOG_ZERO into the last lane."""
    r = jnp.roll(v, -1, axis=-1)
    return r.at[..., -1].set(LOG_ZERO)


@functools.partial(jax.jit, static_argnames=())
def hmm5_fb_qpx(xp, yp, lx, ly, init, trans, lmatch, lins):
    """Forward+backward match planes and total, reference arithmetic.

    xp/yp: (B, Lp) int8 classes (PAD padding); lx/ly true lengths.
    init/trans: log f32 (5,), (5, 5); lmatch (21, 21); lins (21, 2).
    Returns (fwd_m (D, B, W), bwd_m (D, B, W), total (B,)) with
    total = (totalF + totalB) / 2 (PosteriorStage.cpp:141).
    """
    b, lp = xp.shape
    W = lp + 1
    D = 2 * lp + 1
    lane = jnp.arange(W, dtype=jnp.int32)[None, :]
    em_match, insx0, insx1, insy0, insy1 = _skew_emissions(
        xp, yp, lmatch, lins
    )
    lxv = lx.astype(jnp.int32)[:, None]
    lyv = ly.astype(jnp.int32)[:, None]
    dterm = (lxv + lyv)[:, 0]
    Z = jnp.full((b, W), LOG_ZERO, jnp.float32)

    t = trans
    i5 = init

    # ---------------- forward ----------------
    def fstep(carry, inp):
        d, em, ix0, ix1, tot = (
            inp["d"], inp["em"], inp["ix0"], inp["ix1"], None,
        )
        p1, p2, tot = carry            # dicts of 5 states, total (B,)
        i = d - lane                   # (1, W) broadcast over B

        # match: LPE chain over the five d-2 states at lane j-1
        # (ParallelProbabilisticModel.cpp:91-96), state order X1 Y1 X2 Y2
        acc = _shift1(p2["m"]) + t[0, 0]
        acc = jnp.where(acc > LOG_ZERO / 2, acc, LOG_ZERO)
        for k, s in ((1, "x1"), (2, "y1"), (3, "x2"), (4, "y2")):
            acc = log_add(acc, jnp.where(
                _shift1(p2[s]) == LOG_ZERO, LOG_ZERO,
                _shift1(p2[s]) + t[k, 0],
            ))
        m_new = acc + em
        # init cell (1, 1): preset, recurrence skipped (MSA-style)
        m_new = jnp.where((d == 2) & (lane == 1), i5[0] + em, m_new)
        m_new = jnp.where((i >= 1) & (lane >= 1), m_new, LOG_ZERO)

        # x inserts (i-1, j) at d-1, same lane
        def xq(q, sname, ins):
            v = ins + log_add(
                jnp.where(p1["m"] == LOG_ZERO, LOG_ZERO,
                          p1["m"] + t[0, q]),
                jnp.where(p1[sname] == LOG_ZERO, LOG_ZERO,
                          p1[sname] + t[q, q]),
            )
            v = jnp.where((d == 1) & (lane == 0), i5[q] + ins, v)
            return jnp.where(i >= 1, v, LOG_ZERO)

        # y inserts (i, j-1) at d-1, lane j-1
        def yq(q, sname, ins):
            v = ins + log_add(
                jnp.where(_shift1(p1["m"]) == LOG_ZERO, LOG_ZERO,
                          _shift1(p1["m"]) + t[0, q]),
                jnp.where(_shift1(p1[sname]) == LOG_ZERO, LOG_ZERO,
                          _shift1(p1[sname]) + t[q, q]),
            )
            v = jnp.where((d == 1) & (lane == 1), i5[q] + ins, v)
            return jnp.where((lane >= 1) & (i >= 0), v, LOG_ZERO)

        new = {
            "m": m_new,
            "x1": xq(1, "x1", ix0),
            "y1": yq(2, "y1", insy0),
            "x2": xq(3, "x2", ix1),
            "y2": yq(4, "y2", insy1),
        }
        # total at (lx, ly): LPE order M, X1, Y1, X2, Y2
        # (ParallelProbabilisticModel.cpp:124-130)
        at_term = d == dterm           # (B,)
        sel = (lane == lyv).astype(jnp.float32)

        def pick(vname):
            return jnp.sum(
                jnp.where(lane == lyv, new[vname], 0.0), axis=1
            )

        cand = jnp.full((b,), LOG_ZERO)
        for k, s in ((0, "m"), (1, "x1"), (2, "y1"), (3, "x2"),
                     (4, "y2")):
            v = pick(s)
            cand = log_add(cand, jnp.where(v == 0.0, LOG_ZERO,
                                           v + i5[k]))
        tot = jnp.where(at_term, cand, tot)
        return (new, p1, tot), m_new

    zstate = {k: Z for k in ("m", "x1", "y1", "x2", "y2")}
    carry0 = (zstate, zstate, jnp.full((b,), LOG_ZERO))
    (pf1, pf2, total_f), fwd_m = jax.lax.scan(
        fstep, carry0,
        {
            "d": jnp.arange(D, dtype=jnp.int32),
            "em": em_match,
            "ix0": insx0,
            "ix1": insx1,
        },
    )

    # ---------------- backward ----------------
    # next chars: c1 = x_{i+1}, c2 = y_{j+1}; emission/ins planes
    # shifted one step in i / j respectively
    # em_next[d, j] = lmatch[x_{(d-j)+1}, y_{j+1}] = em_match[d+2, j+1]
    pad_row = jnp.full((2, b, W), LOG_ZERO, jnp.float32)
    em_next = jnp.concatenate(
        [_shiftm1(em_match)[2:], pad_row], axis=0
    )
    insx0_next = jnp.concatenate([insx0[1:], pad_row[:1]], axis=0)
    insx1_next = jnp.concatenate([insx1[1:], pad_row[:1]], axis=0)
    insy0_next = _shiftm1(insy0)
    insy1_next = _shiftm1(insy1)

    def bstep(carry, inp):
        d, em_n, ix0_n, ix1_n = (
            inp["d"], inp["em"], inp["ix0"], inp["ix1"],
        )
        n1, n2 = carry                 # states at d+1, d+2
        i = d - lane
        mask_i = i < lxv               # i < L1 (per pair)
        mask_j = lane < lyv
        valid = (i >= 0) & (lane >= 0) & (i <= lxv) & (lane <= lyv)

        # ProbXY = b[i+1, j+1] + matchProb(c1, c2): d+2, lane j+1
        pxy = jnp.where(
            _shiftm1(n2["m"]) == LOG_ZERO, LOG_ZERO,
            _shiftm1(n2["m"]) + em_n,
        )
        mm = mask_i & mask_j

        def guard(mask, v):
            return jnp.where(mask, v, LOG_ZERO)

        # order into b: M, X1, X2, Y1, Y2
        # (ParallelProbabilisticModel.cpp:198-218)
        acc = guard(mm, jnp.where(pxy == LOG_ZERO, LOG_ZERO,
                                  pxy + t[0, 0]))
        x1t = guard(mask_i, jnp.where(
            n1["x1"] == LOG_ZERO, LOG_ZERO,
            n1["x1"] + ix0_n + t[0, 1]))
        x2t = guard(mask_i, jnp.where(
            n1["x2"] == LOG_ZERO, LOG_ZERO,
            n1["x2"] + ix1_n + t[0, 3]))
        y1t = guard(mask_j, jnp.where(
            _shiftm1(n1["y1"]) == LOG_ZERO, LOG_ZERO,
            _shiftm1(n1["y1"]) + insy0_next + t[0, 2]))
        y2t = guard(mask_j, jnp.where(
            _shiftm1(n1["y2"]) == LOG_ZERO, LOG_ZERO,
            _shiftm1(n1["y2"]) + insy1_next + t[0, 4]))
        for term in (x1t, x2t, y1t, y2t):
            acc = log_add(acc, term)
        b_new = acc

        # insert-state levels
        def lvl(pterm, ext):
            v = jnp.where(pxy == LOG_ZERO, LOG_ZERO, pxy + pterm)
            v = guard(mm, v)
            return log_add(v, ext)

        x1_new = lvl(t[1, 0], guard(mask_i, jnp.where(
            n1["x1"] == LOG_ZERO, LOG_ZERO,
            n1["x1"] + ix0_n + t[1, 1])))
        x2_new = lvl(t[3, 0], guard(mask_i, jnp.where(
            n1["x2"] == LOG_ZERO, LOG_ZERO,
            n1["x2"] + ix1_n + t[3, 3])))
        y1_new = lvl(t[2, 0], guard(mask_j, jnp.where(
            _shiftm1(n1["y1"]) == LOG_ZERO, LOG_ZERO,
            _shiftm1(n1["y1"]) + insy0_next + t[2, 2])))
        y2_new = lvl(t[4, 0], guard(mask_j, jnp.where(
            _shiftm1(n1["y2"]) == LOG_ZERO, LOG_ZERO,
            _shiftm1(n1["y2"]) + insy1_next + t[4, 4])))

        # terminal cell (lx, ly): initial distribution
        at_cell = (d == dterm[:, None]) & (lane == lyv)
        b_new = jnp.where(at_cell, i5[0], b_new)
        x1_new = jnp.where(at_cell, i5[1], x1_new)
        y1_new = jnp.where(at_cell, i5[2], y1_new)
        x2_new = jnp.where(at_cell, i5[3], x2_new)
        y2_new = jnp.where(at_cell, i5[4], y2_new)

        b_new = jnp.where(valid, b_new, LOG_ZERO)
        new = {
            "m": b_new,
            "x1": jnp.where(valid, x1_new, LOG_ZERO),
            "y1": jnp.where(valid, y1_new, LOG_ZERO),
            "x2": jnp.where(valid, x2_new, LOG_ZERO),
            "y2": jnp.where(valid, y2_new, LOG_ZERO),
        }
        return (new, n1), new

    carry0b = (zstate, zstate)
    ds = jnp.arange(D - 1, -1, -1, dtype=jnp.int32)
    (bn1, bn2), brows = jax.lax.scan(
        bstep, carry0b,
        {
            "d": ds,
            "em": em_next[ds],
            "ix0": insx0_next[ds],
            "ix1": insx1_next[ds],
        },
    )
    bwd = {k: brows[k][::-1] for k in brows}
    bwd_m = bwd["m"]

    # backward total (ParallelProbabilisticModel.cpp:228-233):
    # total = init0 + matchProb(x1, y1) + b[1,1]; then k loop X1, Y1,
    # X2, Y2 with the (1,0)/(0,1) insert levels
    em11 = em_match[2][:, 1]                  # lmatch[x1, y1] per pair
    ins_x1_0 = insx0[1][:, 0]                 # lins[x1, 0]
    ins_x1_1 = insx1[1][:, 0]
    ins_y1_0 = insy0[:, 1]
    ins_y1_1 = insy1[:, 1]
    total_b = i5[0] + em11 + bwd_m[2][:, 1]
    for kinit, ins, row, lanei in (
        (1, ins_x1_0, bwd["x1"][1], 0),
        (2, ins_y1_0, bwd["y1"][1], 1),
        (3, ins_x1_1, bwd["x2"][1], 0),
        (4, ins_y1_1, bwd["y2"][1], 1),
    ):
        total_b = log_add(total_b, i5[kinit] + ins + row[:, lanei])

    total = (total_f + total_b) * jnp.float32(0.5)
    return fwd_m, bwd_m, total


@jax.jit
def local_posterior_qpx(xp, yp, lx, ly, ltrans, log_stay, lmatch, lins):
    """baseMSA 3-state local-HMM posterior, reference arithmetic.

    The local model runs in ODDS space: every term carries
    -insProb(x)-insProb(y) and -2*random_transProb[1] factors
    (ProbabilisticModel.h:213-258 flag=false branches); flanking random
    states let the alignment start/end anywhere, so the total
    accumulates over ALL (i>0, j>0) cells (ibid:420-434).  The totals
    are the one deviation from op-order fidelity: the reference chains
    LOG_PLUS_EQUALS row-major over the whole plane; we use an exact
    stable log-sum-exp instead (the LOOKUP fit error on the comparable-
    magnitude terms bounds the difference at ~1e-4 in log space).

    ltrans: (3, 3) log local transitions; log_stay = log(1 - leave)
    (= random_transProb[1]); lmatch (21, 21); lins (21,).
    Returns (D, B, W) posterior.
    """
    b, lp = xp.shape
    W = lp + 1
    D = 2 * lp + 1
    lane = jnp.arange(W, dtype=jnp.int32)[None, :]
    lxv = lx.astype(jnp.int32)[:, None]
    lyv = ly.astype(jnp.int32)[:, None]
    Z = jnp.full((b, W), LOG_ZERO, jnp.float32)
    rt1 = log_stay.astype(jnp.float32)
    t = ltrans

    # em'[d, b, j] = lmatch[x_i, y_j] - lins[x_i] - lins[y_j] - 2*rt1
    xg = jnp.concatenate(
        [jnp.full((b, 1), PAD, xp.dtype), xp], axis=1
    ).astype(jnp.int32)
    yg = jnp.concatenate(
        [jnp.full((b, 1), PAD, yp.dtype), yp], axis=1
    ).astype(jnp.int32)
    d_idx = jnp.arange(D, dtype=jnp.int32)[:, None]
    j_idx = jnp.arange(W, dtype=jnp.int32)[None, :]
    i_idx = jnp.clip(d_idx - j_idx, 0, lp)
    xsk = xg[:, i_idx]                                   # (B, D, W)
    em = (lmatch[xsk, yg[:, None, :]] - lins[xsk]
          - lins[yg][:, None, :] - 2.0 * rt1)
    em = jnp.moveaxis(em, 0, 1)                          # (D, B, W)

    def fstep(carry, inp):
        d, emr = inp
        p1, p2 = carry
        i = d - lane
        # match: acc = em'; then LPE over the three d-2 states
        acc = emr
        for k in range(3):
            prev = _shift1(p2[k])
            acc = log_add(acc, jnp.where(
                prev == LOG_ZERO, LOG_ZERO, emr + prev + t[k, 0]
            ))
        m_new = jnp.where((i >= 1) & (lane >= 1), acc, LOG_ZERO)
        # X: (i-1, j) at d-1 same lane
        x_new = log_add(
            jnp.where(p1[0] == LOG_ZERO, LOG_ZERO,
                      p1[0] + t[0, 1] - rt1),
            jnp.where(p1[1] == LOG_ZERO, LOG_ZERO,
                      p1[1] + t[1, 1] - rt1),
        )
        x_new = jnp.where(i >= 1, x_new, LOG_ZERO)
        # Y: (i, j-1) at d-1 lane j-1
        y_new = log_add(
            jnp.where(_shift1(p1[0]) == LOG_ZERO, LOG_ZERO,
                      _shift1(p1[0]) + t[0, 2] - rt1),
            jnp.where(_shift1(p1[2]) == LOG_ZERO, LOG_ZERO,
                      _shift1(p1[2]) + t[2, 2] - rt1),
        )
        y_new = jnp.where((lane >= 1) & (i >= 0), y_new, LOG_ZERO)
        new = (m_new, x_new, y_new)
        return (new, p1), m_new

    zst = (Z, Z, Z)
    (_, _), fwd_m = jax.lax.scan(
        fstep, (zst, zst),
        (jnp.arange(D, dtype=jnp.int32), em),
    )

    # backward: em' of the NEXT cell (i+1, j+1) = em[d+2] shifted -1
    pad2 = jnp.full((2, b, W), LOG_ZERO, jnp.float32)
    em_next = jnp.concatenate([_shiftm1(em)[2:], pad2], axis=0)

    def bstep(carry, inp):
        d, em_n = inp
        n1, n2 = carry
        i = d - lane
        mask_i = i < lxv
        mask_j = lane < lyv
        valid = (i >= 0) & (i <= lxv) & (lane <= lyv)
        pxy = jnp.where(
            _shiftm1(n2[0]) == LOG_ZERO, LOG_ZERO,
            _shiftm1(n2[0]) + em_n,
        )
        mm = mask_i & mask_j

        def guard(mask, v):
            return jnp.where(mask, v, LOG_ZERO)

        # b0 starts at LOG_ONE everywhere (the alignment may end at any
        # cell, ProbabilisticModel.h:339); order M, X, Y
        b0 = jnp.zeros_like(Z)
        b0 = log_add(b0, guard(mm, jnp.where(
            pxy == LOG_ZERO, LOG_ZERO, pxy + t[0, 0])))
        b0 = log_add(b0, guard(mask_i, jnp.where(
            n1[1] == LOG_ZERO, LOG_ZERO,
            n1[1] + t[0, 1] - rt1)))
        b0 = log_add(b0, guard(mask_j, jnp.where(
            _shiftm1(n1[2]) == LOG_ZERO, LOG_ZERO,
            _shiftm1(n1[2]) + t[0, 2] - rt1)))
        bx = log_add(
            guard(mm, jnp.where(pxy == LOG_ZERO, LOG_ZERO,
                                pxy + t[1, 0])),
            guard(mask_i, jnp.where(
                n1[1] == LOG_ZERO, LOG_ZERO,
                n1[1] + t[1, 1] - rt1)),
        )
        by = log_add(
            guard(mm, jnp.where(pxy == LOG_ZERO, LOG_ZERO,
                                pxy + t[2, 0])),
            guard(mask_j, jnp.where(
                _shiftm1(n1[2]) == LOG_ZERO, LOG_ZERO,
                _shiftm1(n1[2]) + t[2, 2] - rt1)),
        )
        b0 = jnp.where(valid, b0, LOG_ZERO)
        new = (b0, jnp.where(valid, bx, LOG_ZERO),
               jnp.where(valid, by, LOG_ZERO))
        return (new, n1), b0

    ds = jnp.arange(D - 1, -1, -1, dtype=jnp.int32)
    (_, _), brows = jax.lax.scan(
        bstep, ((Z, Z, Z), (Z, Z, Z)),
        (ds, em_next[ds]),
    )
    bwd_m = brows[::-1]

    # totals over all interior cells (exact stable LSE; see docstring)
    d3 = jnp.arange(D, dtype=jnp.int32)[:, None, None]
    i3 = d3 - lane[None]
    interior = ((i3 >= 1) & (lane[None] >= 1)
                & (i3 <= lxv[None]) & (lane[None] <= lyv[None]))

    def lse(plane):
        v = jnp.where(interior, plane, -jnp.inf)
        mx = jnp.max(v, axis=(0, 2))
        s = jnp.sum(
            jnp.where(interior, jnp.exp(plane - mx[None, :, None]),
                      0.0),
            axis=(0, 2),
        )
        return mx + jnp.log(s)

    total_f = lse(fwd_m)
    total_b = lse(bwd_m + em)
    total = (total_f + total_b) * jnp.float32(0.5)

    tot = jnp.where(total == 0.0, 1.0, total)[None, :, None]
    p = exp_ref(jnp.minimum(0.0, fwd_m + bwd_m - tot))
    p = jnp.where(interior, p, 0.0)
    return p


def hmm5_posterior_qpx(xp, yp, lx, ly, init, trans, lmatch, lins):
    """(D, B, W) match posterior with reference arithmetic:
    p = EXP(min(0, f + b - total)), p[0, j] = p[i, 0] = 0."""
    fwd_m, bwd_m, total = hmm5_fb_qpx(
        xp, yp, lx, ly, init, trans, lmatch, lins
    )
    D, b, W = fwd_m.shape
    lane = jnp.arange(W, dtype=jnp.int32)[None, None, :]
    d_idx = jnp.arange(D, dtype=jnp.int32)[:, None, None]
    i_idx = d_idx - lane
    tot = jnp.where(total == 0.0, 1.0, total)[None, :, None]
    p = exp_ref(jnp.minimum(0.0, fwd_m + bwd_m - tot))
    # true per-pair extent: the reference plane is exactly
    # (lx+1) x (ly+1); padded cells beyond it are junk
    lxv = lx.astype(jnp.int32)[None, :, None]
    lyv = ly.astype(jnp.int32)[None, :, None]
    p = jnp.where(
        (i_idx >= 1) & (lane >= 1) & (i_idx <= lxv) & (lane <= lyv),
        p, 0.0,
    )
    return p
