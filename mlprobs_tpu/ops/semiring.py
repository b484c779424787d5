"""Log/tropical-semiring primitives for row-scan dynamic programs.

The row-scan formulation of the pair-HMM / partition-function DPs runs a
`lax.scan` over rows.  Within a row, states that consume the column
sequence satisfy a first-order affine recurrence

    u_j = (c_j) OPLUS (d_j OTIMES u_{j-1})

over the log semiring (OPLUS=logaddexp, OTIMES=+) or the tropical semiring
(OPLUS=max).  Affine maps compose associatively:

    (c2,d2) . (c1,d1) = (c2 OPLUS (d2 OTIMES c1), d2 OTIMES d1)

so the whole row resolves in O(log L) depth with `lax.associative_scan`,
keeping the only true sequential dimension to the O(L) row loop.  This
replaces the reference's anti-diagonal wavefront (QuickProbs
Kernels/Probabilistic.cl) with a layout whose inner dimension is dense and
vector-friendly.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Finite stand-in for log(0); safe under f32 accumulation through
# O(log L) associative-scan compositions (|LOG_ZERO| * 2^depth << f32 max).
LOG_ZERO = jnp.float32(-1e30)


def logaddexp(a, b):
    return jnp.logaddexp(a, b)


def logsumexp(xs, axis=None):
    return jax.scipy.special.logsumexp(xs, axis=axis)


def _log_combine(left, right):
    """Compose affine maps in the log semiring; `right` applied after."""
    c1, d1 = left
    c2, d2 = right
    return jnp.logaddexp(c2, d2 + c1), d1 + d2


def _max_combine(left, right):
    c1, d1 = left
    c2, d2 = right
    return jnp.maximum(c2, d2 + c1), d1 + d2


def affine_scan_log(c, d, init=None, reverse: bool = False, axis: int = -1):
    """Solve u_j = logaddexp(c_j, d_j + u_(j-1)) along `axis`.

    With reverse=True solves u_j = logaddexp(c_j, d_j + u_(j+1)).
    `init` is the value of u just outside the scanned range (defaults to
    LOG_ZERO, i.e. no inflow).
    """
    axis = axis % c.ndim
    cc, dd = jax.lax.associative_scan(
        _log_combine, (c, d), reverse=reverse, axis=axis
    )
    if init is None:
        return cc
    return jnp.logaddexp(cc, dd + init)


def affine_scan_max(c, d, init=None, reverse: bool = False, axis: int = -1):
    """Tropical-semiring version: u_j = max(c_j, d_j + u_(j-1))."""
    axis = axis % c.ndim
    cc, dd = jax.lax.associative_scan(
        _max_combine, (c, d), reverse=reverse, axis=axis
    )
    if init is None:
        return cc
    return jnp.maximum(cc, dd + init)


def shift_right(row, fill=LOG_ZERO):
    """[a,b,c] -> [fill,a,b] along the last axis."""
    return jnp.concatenate(
        [jnp.full(row.shape[:-1] + (1,), fill, row.dtype), row[..., :-1]],
        axis=-1,
    )


def shift_left(row, fill=LOG_ZERO):
    """[a,b,c] -> [b,c,fill] along the last axis."""
    return jnp.concatenate(
        [row[..., 1:], jnp.full(row.shape[:-1] + (1,), fill, row.dtype)],
        axis=-1,
    )
