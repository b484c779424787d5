"""Probalign partition-function posterior, log-space row-scan.

Reference: MSAPartProbs.cpp partf (:400-660) / revers_partf (:78-396) /
ComputePostProbs (:665-727).  The reference computes in probability space
with `long double`; this formulation works in log space (float32), the
same trick the reference's own GPU port uses
(QuickProbs Kernels/PartitionLogarithm.cl).

Model: match state Zm with emission exp(beta*score(a,b)); affine gap
states Ze (consumes y) / Zf (consumes x) with open exp(beta*-22) and
extend exp(beta*-1); terminal gaps are free.  The posterior of a match at
(i, j) is  Zm_fwd(i,j) * Zm_rev(i,j) / (score(i,j) * Z).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from mlprobs_tpu.ops.semiring import (
    LOG_ZERO,
    affine_scan_log,
    shift_right,
)


def _lse3(a, b, c):
    return jnp.logaddexp(jnp.logaddexp(a, b), c)


def _partition_forward(x, y, lx, ly, p):
    """Log Zm plane (Lx+1, Ly+1) and log total partition function."""
    Lx, Ly = x.shape[0], y.shape[0]
    lsc = p["lscore"][x[:, None], y[None, :]]        # (Lx, Ly)
    lsc = jnp.concatenate(
        [jnp.full((Lx, 1), LOG_ZERO), lsc], axis=1
    )                                                # (Lx, Ly+1)
    lgo, lge = p["lgap_open"], p["lgap_ext"]
    jidx = jnp.arange(Ly + 1)
    zero_row = jnp.full(Ly + 1, LOG_ZERO)

    # gap-in-x (Ze) costs: free when x is exhausted (terminal gap)
    # gap-in-y (Zf) costs: free before y starts (j==0) or after it ends
    go_f = jnp.where((jidx == 0) | (jidx == ly), 0.0, lgo)
    ge_f = jnp.where((jidx == 0) | (jidx == ly), 0.0, lge)

    # row 0: zm(0,0)=1, ze(0,j>=1)=1 (free leading gap in x), zf=0
    zm0 = jnp.where(jidx == 0, 0.0, LOG_ZERO)
    ze0 = jnp.where(jidx >= 1, 0.0, LOG_ZERO)
    zf0 = zero_row

    def step(carry, i):
        pzm, pze, pzf = carry
        at_end = i == lx
        # Zf: consumes x; element-wise from the previous row
        zf = jnp.logaddexp(pzm + go_f, pzf + ge_f)
        zf = zf.at[0].set(0.0)  # free leading gap in y (Zf[i][0] = 1)
        # Zm: from any state at (i-1, j-1)
        zm = lsc[i - 1] + shift_right(_lse3(pzm, pze, pzf))
        # Ze: consumes y; within-row recurrence, free when x exhausted
        go_e = jnp.where(at_end, 0.0, lgo)
        ge_e = jnp.where(at_end, 0.0, lge)
        c = shift_right(zm) + go_e
        d = jnp.full_like(c, ge_e)
        ze = jnp.concatenate(
            [zero_row[:1], affine_scan_log(c[1:], d[1:])]
        )
        total_here = _lse3(zm[ly], ze[ly], zf[ly])
        return (zm, ze, zf), (zm, total_here)

    carry0 = (zm0, ze0, zf0)
    _, (zm_rows, totals) = jax.lax.scan(step, carry0, jnp.arange(1, Lx + 1))
    lzm = jnp.concatenate([zm0[None, :], zm_rows], axis=0)
    totals = jnp.concatenate(
        [jnp.array([_lse3(zm0[ly], ze0[ly], zf0[ly])]), totals]
    )
    return lzm, totals[lx]


def _reverse_seq(s, length):
    """Reverse the valid prefix of a padded sequence in place."""
    return jnp.roll(s[::-1], length - s.shape[0])


def partition_posterior(x, y, lx, ly, p):
    """Match posterior plane, 0-based (Lx, Ly); zero outside (lx, ly)."""
    Lx, Ly = x.shape[0], y.shape[0]
    lzm_f, ltotal = _partition_forward(x, y, lx, ly, p)
    xr = _reverse_seq(x, lx)
    yr = _reverse_seq(y, ly)
    lzm_rrev, _ = _partition_forward(xr, yr, lx, ly, p)
    # align: rev plane cell (lx-i+1, ly-j+1) -> (i, j)
    flipped = lzm_rrev[::-1, ::-1]
    lzm_r = jnp.roll(
        flipped, shift=(lx + 1 - Lx, ly + 1 - Ly), axis=(0, 1)
    )
    lsc = p["lscore"][x[:, None], y[None, :]]        # (Lx, Ly)
    lpost = lzm_f[1:, 1:] + lzm_r[1:, 1:] - lsc - ltotal
    post = jnp.exp(jnp.minimum(0.0, lpost))
    ivalid = jnp.arange(Lx)[:, None] < lx
    jvalid = jnp.arange(Ly)[None, :] < ly
    return jnp.where(ivalid & jvalid, post, 0.0)
