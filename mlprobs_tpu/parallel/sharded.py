"""Multi-chip sharded pipeline stages.

`make_sharded_posterior_step` is the distributed form of the posterior
stage: the batch-of-pairs axis is sharded across devices (pure data
parallelism — each device sweeps its own pairs) and the consistency
contraction all-gathers the z-rows inside a shard_map (over NVLink on a
multi-GPU host).

This is what the reference cannot do at all (single process, OpenMP);
see SURVEY §2.9 / §5.8 for the mapping.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from mlprobs_tpu.align import pairwise
from mlprobs_tpu.ops import wavefront


_MODELS = ("hmm5", "partition", "local")


def make_sharded_posterior_step(mesh: Mesh):
    """Jitted (X, Y, LX, LY) -> (posteriors, scores), pairs-sharded.

    X/Y: (B, Lp) int8 with B divisible by the mesh size; each device
    runs the fused wavefront engine (ops/wavefront.py) on its local
    shard of pairs — pure data parallelism over the pair axis, the
    device mapping of the reference's OpenMP pair loop (SURVEY §2.9).
    Outputs keep the pairs sharding, so downstream per-shard work stays
    device-local.
    Posteriors are returned unskewed (B, Lp, Lp).
    """
    tabs_f, tabs_r = pairwise._wf_tables("mix", None)

    def local_step(x, y, lx, ly):
        b, lp = x.shape
        # The wavefront engine's contract is PAD (=20) beyond the true
        # length: the local model's start-anywhere injection is masked
        # by bounds, but its emissions are not, so non-PAD garbage in
        # the pad region leaks posterior mass.  Enforce it here.
        col = jnp.arange(lp, dtype=jnp.int32)[None, :]
        x = jnp.where(col < lx[:, None], x, wavefront.PAD).astype(x.dtype)
        y = jnp.where(col < ly[:, None], y, wavefront.PAD).astype(y.dtype)
        zero = jnp.zeros((b,), jnp.int32)
        fwd = wavefront.wavefront_forward(
            x, y, zero, zero, lx, ly, tabs_f,
            models=_MODELS, emit_pre=False,
        )
        rev = wavefront.wavefront_forward(
            x[:, ::-1], y[:, ::-1], lp - lx, lp - ly, lx, ly, tabs_r,
            models=_MODELS, emit_pre=True,
        )
        acc = None
        for m in _MODELS:
            pm = wavefront.posterior_skew(fwd, rev, m)
            acc = pm * pm if acc is None else acc + pm * pm
        post = jnp.sqrt(acc / len(_MODELS))
        score = wavefront.mwt_skew(post, lx, ly)
        # unskew for the dense consistency consumer: tiny shapes only
        # (the production host path keeps everything skewed)
        w = lp + 1
        i = jnp.arange(lp)[:, None]
        wl = jnp.arange(w)[None, :]
        # out1[b, i, wl] = post[i + wl + 1, b, wl]
        unsk = jnp.take_along_axis(
            jnp.moveaxis(post, 0, 1),
            jnp.broadcast_to((i + wl + 1)[None], (b, lp, w)),
            axis=1,
        )
        # out[b, i, j] = out1[b, i, j + 1] = post[i + j + 2, b, j + 1]
        return unsk[:, :, 1:], score

    fn = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P("pairs"), P("pairs"), P("pairs"), P("pairs")),
        out_specs=(P("pairs"), P("pairs")),
        check_vma=False,
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=8)
def make_sharded_consistency(mesh: Mesh, num_seqs: int,
                             cutoff: float = 0.01):
    """One consistency round over a pairs-sharded dense (N, N, Lp, Lp).

    The i-axis (rows of the pair matrix) is sharded; each device
    all-gathers the full tensor's z-rows and contracts its local row
    block — the multi-device form of the production
    consistency.relax_dense_rounds update (same coefficient
    parametrisation: R_ij = sc*S_ij + zs*sum_z w_z S_iz @ S_zj on a
    zero-diagonal tensor, masked to support and re-thresholded at
    `cutoff`; the same f32 precision).
    """

    def local_round(s_local, self_coef, z_scale, w):
        # s_local: (N/n_dev, N, Lp, Lp); coef rows sharded alongside
        s_all = jax.lax.all_gather(
            s_local, "pairs", axis=0, tiled=True
        )  # (N, N, Lp, Lp)
        prod = jnp.einsum(
            "izab,z,zjbc->ijac",
            s_local,
            w,
            s_all,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        r = (self_coef[:, :, None, None] * s_local
             + z_scale[:, :, None, None] * prod)
        return jnp.where((s_local > 0) & (r >= cutoff), r, 0.0)

    fn = shard_map(
        local_round,
        mesh=mesh,
        in_specs=(P("pairs"), P("pairs"), P("pairs"), P()),
        out_specs=P("pairs"),
        check_vma=False,
    )
    return jax.jit(fn)
