"""Anti-diagonal wavefront DP engine in scaled probability space.

The accelerator formulation of the posterior stage's inner loops.  The
reference computes pair-HMM / partition-function DPs either as OpenMP
row loops (baseMSA ProbabilisticModel.h:153-274, MSAPartProbs.cpp:400-660)
or as OpenCL anti-diagonal wavefront kernels (QuickProbs
Kernels/Probabilistic.cl, Kernels/Partition.cl).  This module is the
wavefront formulation expressed as one `lax.scan` over anti-diagonals:

* **Skewed layout** — diagonal d (= i + j) is one (B, W) vector row;
  lane j holds grid cell (i = d - j, j).  The three DP dependencies
  (i-1,j-1) / (i-1,j) / (i,j-1) become rows d-2 (lane j-1) and d-1
  (lanes j, j-1): every state update is an element-wise FMA plus a
  lane shift.  No within-row associative scans (unlike ops/pairhmm.py),
  so a diagonal step costs a handful of vector ops.  Each scan step
  launches its own device kernels, whose fixed cost dominates a step,
  so the engine fuses all requested models into one scan and batches
  pairs wide.

* **Scaled probability space** — instead of log-space logaddexp chains,
  states are probabilities rescaled per diagonal by an exact power of
  two (stored = true * 2^S, S tracked per pair per diagonal;
  rescaling by 2^-floor(log2(max)) is exact in f32).  This replaces
  ~20-cycle transcendentals with single FMAs; the reference's own
  probability-space partition function needed long double headroom
  (MSAPartProbs.cpp:22), which per-diagonal rescaling supplies in f32.

* **Backward = forward on reversed sequences** — the backward plane
  needed by the posterior equals the *pre-emission M accumulator* of a
  forward pass over reversed sequences with transposed transitions
  (initDistrib serves as both start and end distribution,
  ProbabilisticModel.h:405-454; the reference's own partition reverse
  pass is the same trick, MSAPartProbs.cpp:78-396).  Reversed sequences
  are embedded **right-aligned** in the padded frame (a plain jnp.flip
  of the padded array), which makes the fwd/rev plane correspondence
  the *static* remap  bwd(i,j) = am_rev[2*Lp+2-d, Lp+1-j]  for every
  model — no per-pair index arithmetic.  Offsets (ox, oy) shift
  the DP origin per pair; the padding class (20) has zero emission
  probability, so cells outside the embedded sequences stay exactly
  zero without masking.

* **All consumers stay in skewed space** — posterior combine, the MWT
  accuracy DP (ProbabilisticModel.h:804-864) with its match-count
  carry (MSA.cpp:1745-1752), and the per-diagonal top-k sparsification
  all operate on skewed planes, so the expensive unskew gather never
  happens.  Host code maps (d, j) -> (i, j) = (d - j, j) when building
  CSR posteriors (align.pairwise.topk_diag_to_csr).

* **Exact emission lookups** — per-residue table entries are gathered
  (`_class_rows`, `_pick`), never contracted against one-hot masks: a
  float32 contraction may run in TF32 on a GPU and round every emission
  to ~3 decimal digits.

Models: "hmm5" (5-state double-affine), "local" (3-state odds-ratio
local HMM), "partition" (Probalign Zm/Ze/Zf).  Semantics match the
oracles in ops/pairhmm.py and ops/partition.py.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

PAD = 20  # padding alphabet class; all prob tables are zero for it
TINY = 1e-38


def _zero_pad_class(tab):
    """Zero row/col PAD of a (21, ...) prob table."""
    tab = tab.at[PAD].set(0.0)
    if tab.ndim == 2 and tab.shape[1] == 21:
        tab = tab.at[:, PAD].set(0.0)
    return tab


def hmm5_prob_tables(p, transpose=False):
    """Probability-space tables from the log-space hmm5 param dict."""
    t = jnp.exp(p["trans"])
    return {
        "pm": _zero_pad_class(jnp.exp(p["lmatch"])),    # (21, 21)
        "pins": _zero_pad_class(jnp.exp(p["lins"])),    # (21, 2)
        "T": t.T if transpose else t,                    # (5, 5)
        "init": jnp.exp(p["init"]),                      # (5,)
    }


def local_prob_tables(p, transpose=False):
    """Odds-ratio match table (em' = match - ins_x - ins_y) + transitions."""
    lm = p["lmatch"] - p["lins"][:, None] - p["lins"][None, :]
    t = jnp.exp(p["trans"])
    return {
        "pm": _zero_pad_class(jnp.exp(lm)),
        "T": t.T if transpose else t,                    # (3, 3)
        "c1": jnp.exp(-p["log_stay"]),
        "c2": jnp.exp(-2.0 * p["log_stay"]),
    }


def partition_prob_tables(p, transpose=False):
    # the reverse partition recursion is the forward one on reversed
    # sequences (MSAPartProbs.cpp revers_partf; ops/partition.py) —
    # no transposition needed.
    del transpose
    return {
        "pm": _zero_pad_class(jnp.exp(p["lscore"])),
        "go": jnp.exp(p["lgap_open"]),
        "ge": jnp.exp(p["lgap_ext"]),
    }


PROB_TABLES = {
    "hmm5": hmm5_prob_tables,
    "local": local_prob_tables,
    "partition": partition_prob_tables,
}


def _class_rows(tab, cls):
    """tab[cls]: the (21, ...) table's row for every class in `cls`
    (an exact gather; cls holds alphabet classes 0..20)."""
    return jnp.take(tab, cls.astype(jnp.int32), axis=0, mode="clip")


def _lane_table(ygrid, pm):
    """colt[b, j, c] = pm[c, ygrid[b, j]]  -> (B, W, 21)."""
    return _class_rows(pm.T, ygrid)


def _pick(colt, xrow):
    """colt[b, j, xrow[b, j]]: the emission of cell (xrow, lane j)."""
    return jnp.take_along_axis(
        colt, xrow.astype(jnp.int32)[..., None], axis=-1, mode="clip"
    )[..., 0]


def _shift1(v):
    """lane j -> value from lane j-1 (zero-fill): the (·, j-1) dependency."""
    return jnp.concatenate([jnp.zeros_like(v[:, :1]), v[:, :-1]], axis=1)


def _rescale(states, s_prev):
    """Per-pair exact power-of-two renormalisation of a state tuple."""
    mx = states[0]
    for v in states[1:]:
        mx = jnp.maximum(mx, v)
    mx = jnp.max(mx, axis=1)                        # (B,)
    e = jnp.where(mx > 0, jnp.floor(jnp.log2(jnp.maximum(mx, TINY))), 0.0)
    f = jnp.exp2(-e)
    return tuple(v * f[:, None] for v in states), f, s_prev - e


@functools.partial(
    jax.jit, static_argnames=("models", "emit_pre", "emit_dtype")
)
def wavefront_forward(
    xp, yp, ox, oy, lx, ly, tables,
    models: tuple[str, ...] = ("hmm5",),
    emit_pre: bool = False,
    emit_dtype=jnp.float32,
):
    """Fused multi-model forward wavefront over one padded pair batch.

    xp/yp: (B, Lp) int8 class arrays, PAD beyond the embedded sequence.
    ox/oy: (B,) int32 embedding offsets (0 for the forward pass;
           Lp - lx / Lp - ly for the right-aligned reversed pass).
    lx/ly: (B,) true lengths.
    tables: dict model -> prob tables (PROB_TABLES[m](params, transpose)).
    emit_pre: emit the pre-emission M accumulator (reverse-pass mode)
           instead of the post-emission M / Zm plane.

    Returns dict with, per model m:
      planes[m]: (D, B, W) emit_dtype,
      scales[m]: (D, B) f32 cumulative log2 scale S (stored=true*2^S),
      log2t[m]:  (B,) f32 log2 of the model's total probability.
    D = 2*Lp + 1, W = Lp + 1; plane row d, lane j = grid cell (d-j, j).
    """
    B, Lp = xp.shape
    W = Lp + 1
    D = 2 * Lp + 1
    lane = jnp.arange(W, dtype=jnp.int32)[None, :]   # (1, W)

    xflip = xp[:, ::-1]
    padb = jnp.full((B, Lp + 1), PAD, xp.dtype)
    xfeed = jnp.concatenate([padb, xflip, padb], axis=1)  # (B, 3Lp+2)
    ygrid = jnp.concatenate(
        [jnp.full((B, 1), PAD, yp.dtype), yp], axis=1
    )                                                  # (B, W)

    colt = {m: _lane_table(ygrid, tables[m]["pm"]) for m in models}

    h5 = "hmm5" in models
    if h5:
        t5 = tables["hmm5"]
        iy = _class_rows(t5["pins"], ygrid)           # (B, W, 2)
        ixfeed = _class_rows(t5["pins"], xfeed)       # (B, 3Lp+2, 2)
        T5, init5 = t5["T"], t5["init"]
    if "local" in models:
        tl = tables["local"]
        TL, c1, c2 = tl["T"], tl["c1"], tl["c2"]
    if "partition" in models:
        tp = tables["partition"]
        go, ge = tp["go"], tp["ge"]

    oxc, oyc = ox[:, None], oy[:, None]
    lane_oy = lane == oyc                   # original column 0
    lane_oy1 = lane == oyc + 1              # original column 1
    lane_end = lane == (oyc + ly[:, None])  # original column ly
    term_sel = lane_end.astype(jnp.float32)
    dterm = ox + lx + oy + ly               # terminal diagonal per pair

    zero = jnp.zeros((B, W), jnp.float32)
    zs = jnp.zeros((B,), jnp.float32)
    ones = jnp.ones((B,), jnp.float32)

    def capture(row):
        return jnp.sum(row * term_sel, axis=1)

    carry0 = {}
    if h5:
        carry0["hmm5"] = {
            "d1": (zero,) * 5, "d2": (zero,) * 5, "r": ones,
            "s1": zs, "s2": zs, "term": (zs,) * 5, "sterm": zs,
        }
    if "local" in models:
        carry0["local"] = {
            "d1": (zero,) * 3, "d2": (zero,) * 3, "r": ones,
            "s1": zs, "s2": zs, "acc": jnp.full((B,), -jnp.inf),
        }
    if "partition" in models:
        carry0["partition"] = {
            "d1": (zero,) * 3, "d2": (zero,) * 3, "r": ones,
            "s1": zs, "s2": zs, "term": (zs,) * 3, "sterm": zs,
        }

    def step(carry, d):
        start = Lp - d + (Lp + 1)
        xrow = jax.lax.dynamic_slice(xfeed, (0, start), (B, W))
        irow = d - lane                                # embedded row index
        at_term = (d == dterm).astype(jnp.float32)

        new_carry = {}
        out = {}

        if h5:
            c = carry["hmm5"]
            m1, x11, y11, x21, y21 = c["d1"]
            m2, x12, y12, x22, y22 = c["d2"]
            rc, s1 = c["r"][:, None], c["s1"]
            em = _pick(colt["hmm5"], xrow)
            ix = jax.lax.dynamic_slice(ixfeed, (0, start, 0), (B, W, 2))
            # e2s1 may overflow to inf long after the terminal diagonal;
            # it is only ever *selected* where injections fire (small s1),
            # never multiplied by an unselected 0 (that would make NaN).
            e2s1 = jnp.exp2(s1)[:, None]

            inj_m = jnp.where(
                ((d == ox + oy + 2)[:, None]) & lane_oy1,
                init5[0] * e2s1, 0.0,
            )
            am = (
                _shift1(m2) * T5[0, 0]
                + _shift1(x12) * T5[1, 0]
                + _shift1(y12) * T5[2, 0]
                + _shift1(x22) * T5[3, 0]
                + _shift1(y22) * T5[4, 0]
            ) * rc + inj_m
            m_new = em * am

            injx = ((d == ox + oy + 1)[:, None]) & lane_oy
            x1_new = ix[:, :, 0] * (
                m1 * T5[0, 1] + x11 * T5[1, 1]
                + jnp.where(injx, init5[1] * e2s1, 0.0)
            )
            x2_new = ix[:, :, 1] * (
                m1 * T5[0, 3] + x21 * T5[3, 3]
                + jnp.where(injx, init5[3] * e2s1, 0.0)
            )
            injy = ((d == ox + oy + 1)[:, None]) & lane_oy1
            y1_new = iy[:, :, 0] * (
                _shift1(m1) * T5[0, 2] + _shift1(y11) * T5[2, 2]
                + jnp.where(injy, init5[2] * e2s1, 0.0)
            )
            y2_new = iy[:, :, 1] * (
                _shift1(m1) * T5[0, 4] + _shift1(y21) * T5[4, 4]
                + jnp.where(injy, init5[4] * e2s1, 0.0)
            )

            states, f, s_new = _rescale(
                (m_new, x1_new, y1_new, x2_new, y2_new), s1
            )
            term = tuple(
                t * (1.0 - at_term) + at_term * capture(v)
                for t, v in zip(c["term"], states)
            )
            new_carry["hmm5"] = {
                "d1": states, "d2": c["d1"], "r": f, "s1": s_new,
                "s2": s1, "term": term,
                "sterm": c["sterm"] * (1.0 - at_term) + at_term * s_new,
            }
            emit = (am * f[:, None]) if emit_pre else states[0]
            out["hmm5"] = (emit.astype(emit_dtype), s_new)

        if "local" in models:
            c = carry["local"]
            lm1, lxs1, lys1 = c["d1"]
            lm2, lxs2, lys2 = c["d2"]
            rc, s1 = c["r"][:, None], c["s1"]
            em = _pick(colt["local"], xrow)
            e2s1 = jnp.exp2(s1)[:, None]
            # start-anywhere "1" is valid only inside the true grid
            inb = (
                (irow > oxc) & (irow <= oxc + lx[:, None])
                & (lane > oyc) & (lane <= oyc + ly[:, None])
            )
            am = (
                _shift1(lm2) * TL[0, 0]
                + _shift1(lxs2) * TL[1, 0]
                + _shift1(lys2) * TL[2, 0]
            ) * rc + jnp.where(inb, e2s1, 0.0)
            m_new = em * c2 * am
            x_new = c1 * (lm1 * TL[0, 1] + lxs1 * TL[1, 1])
            y_new = c1 * (_shift1(lm1) * TL[0, 2] + _shift1(lys1) * TL[2, 2])

            states, f, s_new = _rescale((m_new, x_new, y_new), s1)
            rowsum = jnp.sum(states[0], axis=1)
            acc = jnp.logaddexp2(
                c["acc"],
                jnp.where(
                    rowsum > 0,
                    jnp.log2(jnp.maximum(rowsum, TINY)) - s_new,
                    -jnp.inf,
                ),
            )
            new_carry["local"] = {
                "d1": states, "d2": c["d1"], "r": f, "s1": s_new,
                "s2": s1, "acc": acc,
            }
            emit = (am * f[:, None]) if emit_pre else states[0]
            out["local"] = (emit.astype(emit_dtype), s_new)

        if "partition" in models:
            c = carry["partition"]
            zm1, ze1, zf1 = c["d1"]
            zm2, ze2, zf2 = c["d2"]
            rc, s1 = c["r"][:, None], c["s1"]
            em = _pick(colt["partition"], xrow)
            e2s1 = jnp.exp2(s1)[:, None]
            row0 = irow == oxc
            col0 = lane_oy
            x_done = irow == oxc + lx[:, None]
            inb = (
                (irow >= oxc) & (irow <= oxc + lx[:, None])
                & (lane >= oyc) & (lane <= oyc + ly[:, None])
            )

            am = _shift1(zm2 + ze2 + zf2) * rc
            zm_new = em * am
            zm_new = jnp.where(row0 & col0 & inb, e2s1 + 0.0 * zm_new, zm_new)

            gof = jnp.where(col0 | lane_end, 1.0, go)
            gef = jnp.where(col0 | lane_end, 1.0, ge)
            zf_new = zm1 * gof + zf1 * gef
            zf_new = jnp.where(
                col0 & (irow > oxc), e2s1 + 0.0 * zf_new, zf_new
            )
            goe = jnp.where(x_done, 1.0, go)
            gee = jnp.where(x_done, 1.0, ge)
            ze_new = _shift1(zm1) * goe + _shift1(ze1) * gee
            ze_new = jnp.where(
                row0 & (lane > oyc), e2s1 + 0.0 * ze_new, ze_new
            )
            zm_new = jnp.where(inb, zm_new, 0.0)
            zf_new = jnp.where(inb, zf_new, 0.0)
            ze_new = jnp.where(inb, ze_new, 0.0)
            am = jnp.where(inb, am, 0.0)

            states, f, s_new = _rescale((zm_new, ze_new, zf_new), s1)
            term = tuple(
                t * (1.0 - at_term) + at_term * capture(v)
                for t, v in zip(c["term"], states)
            )
            new_carry["partition"] = {
                "d1": states, "d2": c["d1"], "r": f, "s1": s_new,
                "s2": s1, "term": term,
                "sterm": c["sterm"] * (1.0 - at_term) + at_term * s_new,
            }
            emit = (am * f[:, None]) if emit_pre else states[0]
            out["partition"] = (emit.astype(emit_dtype), s_new)

        return new_carry, out

    carry_end, ys = jax.lax.scan(
        step, carry0, jnp.arange(D, dtype=jnp.int32)
    )

    res = {"planes": {}, "scales": {}, "log2t": {}}
    for m in models:
        res["planes"][m] = ys[m][0]
        res["scales"][m] = ys[m][1]
    if h5:
        c = carry_end["hmm5"]
        tot = sum(t * w for t, w in zip(c["term"], init5))
        res["log2t"]["hmm5"] = (
            jnp.log2(jnp.maximum(tot, TINY)) - c["sterm"]
        )
    if "local" in models:
        res["log2t"]["local"] = carry_end["local"]["acc"]
    if "partition" in models:
        c = carry_end["partition"]
        tot = c["term"][0] + c["term"][1] + c["term"][2]
        res["log2t"]["partition"] = (
            jnp.log2(jnp.maximum(tot, TINY)) - c["sterm"]
        )
    return res


def _align_rev(plane):
    """Static remap: out[d, ..., j] = plane[2*Lp + 2 - d, ..., Lp + 1 - j].

    plane: (D, B, W).  Rows d<2 and lane 0 of the result are zero-filled
    (they correspond to cells outside the grid).
    """
    flipped = plane[::-1, :, ::-1]       # [t, b, u] = plane[D-1-t, b, W-1-u]
    # want plane[2Lp+2-d] = flipped[d-2] along D; plane[..., Lp+1-j]
    # = flipped[..., j-1] along lanes
    z_d = jnp.zeros_like(flipped[:2])
    shifted = jnp.concatenate([z_d, flipped[:-2]], axis=0)
    z_j = jnp.zeros_like(shifted[..., :1])
    return jnp.concatenate([z_j, shifted[..., :-1]], axis=-1)


def _align_rev_scales(s):
    """Same D-axis remap for (D, B) scale rows."""
    flipped = s[::-1]
    z = jnp.zeros_like(flipped[:2])
    return jnp.concatenate([z, flipped[:-2]], axis=0)


def posterior_skew(fwd, rev, model):
    """Skewed match-posterior plane from a fwd and a reverse-pass result.

    p[d, b, j] = P(x_{d-j} ~ y_j), clamped to [0, 1]; exact zeros
    outside the valid grid.  Totals: hmm5/local average the two
    independently computed totals (ProbabilisticModel.h:464-493 uses
    0.5*(total_f+total_b)); partition uses the forward total
    (MSAPartProbs.cpp ComputePostProbs).
    """
    fp = fwd["planes"][model].astype(jnp.float32)
    rp = _align_rev(rev["planes"][model].astype(jnp.float32))
    sf = fwd["scales"][model]
    sr = _align_rev_scales(rev["scales"][model])
    if model == "partition":
        l2t = fwd["log2t"][model]
    else:
        l2t = 0.5 * (fwd["log2t"][model] + rev["log2t"][model])
    lp = (
        jnp.log2(jnp.maximum(fp, TINY)) + jnp.log2(jnp.maximum(rp, TINY))
        - sf[:, :, None] - sr[:, :, None] - l2t[None, :, None]
    )
    lp = jnp.where((fp > 0) & (rp > 0), lp, -jnp.inf)
    return jnp.exp2(jnp.minimum(lp, 0.0))


def mwt_skew(p_skew, lx, ly, with_matches=False):
    """MWT accuracy DP over a skewed posterior plane (fwd coordinates).

    p_skew: (D, B, W) with p[d, b, j] = posterior of cell (i=d-j, j).
    Returns (score (B,), [nmatches (B,)]): the maximum expected accuracy
    and, optionally, the number of diagonal moves on the optimal path —
    computed as a carried DP (no traceback loop), matching
    ComputeAlignment + the NP path's distance normaliser
    (ProbabilisticModel.h:804-864, MSA.cpp:1745-1752).  Tie-breaking:
    diag >= left >= up (ScoreType.h ChooseBestOfThree).
    """
    D, B, W = p_skew.shape
    lane = jnp.arange(W, dtype=jnp.int32)[None, :]
    dterm = (lx + ly).astype(jnp.int32)
    term_sel = (lane == ly[:, None]).astype(jnp.float32)
    zero = jnp.zeros((B, W), jnp.float32)
    zs = jnp.zeros((B,), jnp.float32)

    def step(carry, inp):
        d, prow = inp
        s1, s2, n1, n2, score, nb = carry
        irow = d - lane
        pd = prow + _shift1(s2)             # diag candidate
        left = _shift1(s1)
        up = s1
        take_d = (pd >= left) & (pd >= up)
        take_l = left >= up
        s_new = jnp.where(take_d, pd, jnp.where(take_l, left, up))
        boundary = (irow <= 0) | (lane == 0)
        s_new = jnp.where(boundary, 0.0, s_new)
        if with_matches:
            nd = _shift1(n2) + 1.0
            nl = _shift1(n1)
            n_new = jnp.where(take_d, nd, jnp.where(take_l, nl, n1))
            n_new = jnp.where(boundary, 0.0, n_new)
        else:
            n_new = n1
        at_term = (d == dterm).astype(jnp.float32)
        score = score * (1.0 - at_term) + at_term * jnp.sum(
            s_new * term_sel, axis=1
        )
        if with_matches:
            nb = nb * (1.0 - at_term) + at_term * jnp.sum(
                n_new * term_sel, axis=1
            )
        return (s_new, s1, n_new, n1, score, nb), None

    carry0 = (zero, zero, zero, zero, zs, zs)
    (s1, s2, n1, n2, score, nb), _ = jax.lax.scan(
        step, carry0,
        (jnp.arange(D, dtype=jnp.int32), p_skew),
    )
    if with_matches:
        return score, nb
    return score


def unskew_posterior(p_skew):
    """(D, B, W) skewed posterior plane -> (B, Lp, Lp) grid plane.

    Grid cell (i, j) (0-based posterior entry) lives at skew row
    d = i + j + 2, lane j + 1.  One device gather per batch; used by the
    dense on-device consistency stage, which wants grid-space planes for
    its matmul (align.consistency.relax_dense_rounds).
    """
    D, B, W = p_skew.shape
    lp = W - 1
    i = jnp.arange(lp, dtype=jnp.int32)[:, None]
    wl = jnp.arange(W, dtype=jnp.int32)[None, :]
    unsk = jnp.take_along_axis(
        jnp.moveaxis(p_skew, 0, 1),
        jnp.broadcast_to((i + wl + 1)[None], (B, lp, W)),
        axis=1,
    )
    # unsk[b, i, wl] = p_skew[i + wl + 1, b, wl]; lane j + 1 -> column j
    return unsk[:, :, 1:]


def topk_skew(p_skew, k, cutoff):
    """Per-diagonal top-k sparsification of a skewed posterior plane.

    Returns (vals (D, B, k) f32, lanes (D, B, k) int32).  Entries below
    `cutoff` are zeroed (SparseMatrix.h:14 cutoff; QuickProbs bounds the
    sparse row length, PackedSparseMatrix::setSparseRowThreshold —
    a per-anti-diagonal bound tracks the alignment path even better
    than a per-row one).
    """
    masked = jnp.where(p_skew >= cutoff, p_skew, 0.0)
    vals, idx = jax.lax.top_k(masked, k)
    return vals, idx.astype(jnp.int32)


# ---------------------------------------------------------------------------
# Viterbi (log-space max-plus wavefront)
# ---------------------------------------------------------------------------

LOG_ZERO = -1e30


def _log_pad_class(tab):
    """LOG_ZERO row/col PAD of a (21, ...) log table."""
    tab = tab.at[PAD].set(LOG_ZERO)
    if tab.ndim == 2 and tab.shape[1] == 21:
        tab = tab.at[:, PAD].set(LOG_ZERO)
    return tab


@jax.jit
def viterbi_wavefront(xp, yp, lx, ly, p, vinit):
    """3-state local-model Viterbi as a log-space max-plus wavefront.

    Same semantics (recurrences, tie-breaks, packed direction bits) as
    ops/viterbi.viterbi_local — max-plus needs no transcendentals, so
    the whole step body is adds/maxes (ComputeViterbiAlignment,
    ProbabilisticModel.h:1043+).

    Returns (dirs (D, B, W) int8 skewed, end_state (B,) int32,
    score (B,) f32).  dirs[d, b, j] is grid cell (d - j, j); unskew on
    the host with a strided view (align.pairwise._unskew_dirs).
    """
    B, Lp = xp.shape
    W = Lp + 1
    D = 2 * Lp + 1
    lane = jnp.arange(W, dtype=jnp.int32)[None, :]

    lm = _log_pad_class(p["lmatch"])
    lins = p["lins"].at[PAD].set(LOG_ZERO)
    lt = p["trans"]

    xflip = xp[:, ::-1]
    padb = jnp.full((B, Lp + 1), PAD, xp.dtype)
    xfeed = jnp.concatenate([padb, xflip, padb], axis=1)
    ygrid = jnp.concatenate(
        [jnp.full((B, 1), PAD, yp.dtype), yp], axis=1
    )
    colt = _lane_table(ygrid, lm)                   # (B, W, 21)
    liy = _class_rows(lins, ygrid)                  # (B, W)
    lixfeed = _class_rows(lins, xfeed)              # (B, 3Lp+2)

    dterm = (lx + ly).astype(jnp.int32)
    term_sel = (lane == ly[:, None]).astype(jnp.float32)
    zrow = jnp.full((B, W), LOG_ZERO)
    zs = jnp.zeros((B,), jnp.float32)

    def step(carry, d):
        m1, x1, y1, m2, x2, y2, term = carry
        start = Lp - d + (Lp + 1)
        xrow = jax.lax.dynamic_slice(xfeed, (0, start), (B, W))
        em = _pick(colt, xrow)
        lix = jax.lax.dynamic_slice(lixfeed, (0, start), (B, W))

        cm = _shift1(m2) + lt[0, 0]
        cx = _shift1(x2) + lt[1, 0]
        cy = _shift1(y2) + lt[2, 0]
        m_new = em + jnp.maximum(jnp.maximum(cm, cx), cy)
        tb_m = jnp.where(
            (cm >= cx) & (cm >= cy), 0, jnp.where(cx >= cy, 1, 2)
        )
        from_m = m1 + lt[0, 1]
        from_x = x1 + lt[1, 1]
        x_new = lix + jnp.maximum(from_m, from_x)
        tb_x = (from_m < from_x).astype(jnp.int32)
        # Y(i, j): both predecessors (M/Y at (i, j-1)) sit at diag d-1,
        # lane j-1
        ym = _shift1(m1) + lt[0, 2]
        yy = _shift1(y1) + lt[2, 2]
        y_new = liy + jnp.maximum(ym, yy)
        tb_y = (ym < yy).astype(jnp.int32)

        at0 = (d == 0) & (lane == 0)
        m_new = jnp.where(at0, vinit[0], m_new)
        x_new = jnp.where(at0, vinit[1], x_new)
        y_new = jnp.where(at0, vinit[2], y_new)

        dirs = (tb_m + 4 * tb_x + 8 * tb_y).astype(jnp.int8)
        at_term = (d == dterm).astype(jnp.float32)
        cap = jnp.stack(
            [jnp.sum(v * term_sel, axis=1) for v in (m_new, x_new, y_new)],
            axis=1,
        )                                           # (B, 3)
        term = term * (1.0 - at_term[:, None]) + at_term[:, None] * cap
        return (m_new, x_new, y_new, m1, x1, y1, term), dirs

    carry0 = (zrow, zrow, zrow, zrow, zrow, zrow, jnp.zeros((B, 3)))
    (m1, x1, y1, m2, x2, y2, term), dirs = jax.lax.scan(
        step, carry0, jnp.arange(D, dtype=jnp.int32)
    )
    final = term + vinit[None, :]
    end_state = jnp.where(
        (final[:, 0] >= final[:, 1]) & (final[:, 0] >= final[:, 2]),
        0,
        jnp.where(final[:, 1] >= final[:, 2], 1, 2),
    ).astype(jnp.int32)
    score = jnp.sum(
        final * (end_state[:, None] == jnp.arange(3)[None, :]), axis=1
    )
    return dirs, end_state, score


@jax.jit
def viterbi_path_stats(dirs_skew, ends, xp, yp, lx, ly, blosum):
    """Device traceback + feature accumulation over a Viterbi batch.

    Walks every pair's optimal path simultaneously (one scan trip per
    path step, all pairs in lockstep), accumulating the -G feature-pass
    quantities (MSA.cpp Alter_ModelAdjustmentTest) without shipping the
    (D, B, W) direction planes to the host — only (B,) scalars and a
    (2*Lp, B) per-step score table (trip t = path position n-1-t).

    Returns (pathlen (B,) int32, matches (B,) int32,
             scores_rev (2*Lp, B) f32).
    """
    D, B, W = dirs_skew.shape
    lp = W - 1
    lane = jnp.arange(W, dtype=jnp.int32)[None, :]
    bl21 = blosum.astype(jnp.float32)                # (21, 21)

    def step(carry, _):
        r, c, state, plen, matches = carry
        active = (r > 0) | (c > 0)
        drow = jnp.take_along_axis(
            dirs_skew, (r + c)[None, :, None], axis=0
        )[0].astype(jnp.int32)                       # (B, W)
        dbits = jnp.sum(
            jnp.where(lane == c[:, None], drow, 0), axis=1
        )                                            # (B,)
        is_m = state == 0
        is_x = state == 1
        nxt = jnp.where(
            is_m, dbits & 3,
            jnp.where(
                is_x,
                jnp.where(dbits & 4, 1, 0),
                jnp.where(dbits & 8, 2, 0),
            ),
        )
        xc = jnp.take_along_axis(
            xp, jnp.maximum(r - 1, 0)[:, None], axis=1
        )[:, 0].astype(jnp.int32)
        yc = jnp.take_along_axis(
            yp, jnp.maximum(c - 1, 0)[:, None], axis=1
        )[:, 0].astype(jnp.int32)
        is_b = active & is_m
        matches = matches + jnp.where(is_b & (xc == yc), 1, 0)
        s = bl21[xc, yc]                             # blosum[xc, yc]
        s = jnp.where(
            is_b & (xc < PAD) & (yc < PAD) & (s < 10.0), s, 0.0
        )
        plen = plen + active.astype(jnp.int32)
        r_new = jnp.where(active & (is_m | is_x), r - 1, r)
        c_new = jnp.where(active & (is_m | (state == 2)), c - 1, c)
        state = jnp.where(active, nxt, state)
        return (r_new, c_new, state, plen, matches), s

    carry0 = (
        lx.astype(jnp.int32), ly.astype(jnp.int32),
        ends.astype(jnp.int32),
        jnp.zeros((B,), jnp.int32), jnp.zeros((B,), jnp.int32),
    )
    (r, c, state, plen, matches), scores_rev = jax.lax.scan(
        step, carry0, None, length=2 * lp
    )
    return plen, matches, scores_rev
