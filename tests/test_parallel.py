"""Multi-device sharding tests on the virtual 8-device CPU mesh."""
import numpy as np

import jax
import jax.numpy as jnp

from mlprobs_tpu.parallel.mesh import pair_sharding, pairs_mesh
from mlprobs_tpu.parallel.sharded import (
    make_sharded_consistency,
    make_sharded_posterior_step,
)


def test_mesh_has_eight_devices():
    assert len(jax.devices()) == 8


def test_sharded_posterior_matches_single_device():
    mesh = pairs_mesh(8)
    rng = np.random.default_rng(0)
    b, lp = 16, 128
    X = jnp.asarray(rng.integers(0, 20, (b, lp)), jnp.int8)
    Y = jnp.asarray(rng.integers(0, 20, (b, lp)), jnp.int8)
    LX = jnp.full((b,), 40, jnp.int32)
    LY = jnp.full((b,), 35, jnp.int32)
    shard = pair_sharding(mesh)
    Xs = jax.device_put(X, shard)
    Ys = jax.device_put(Y, shard)
    LXs = jax.device_put(LX, shard)
    LYs = jax.device_put(LY, shard)

    step = make_sharded_posterior_step(mesh)
    posts, scores = step(Xs, Ys, LXs, LYs)

    # single-device reference via the row-scan oracle models
    from mlprobs_tpu.align import pairwise
    from mlprobs_tpu.ops import mwt, pairhmm, partition

    p5 = pairwise.hmm5_dict()
    pl = pairwise.local_dict()
    pp = pairwise.partition_dict()

    def one(x, y, lx, ly):
        v1 = pairhmm.hmm5_posterior(x, y, lx, ly, p5)
        v2 = partition.partition_posterior(x, y, lx, ly, pp)
        v3 = pairhmm.local_posterior(x, y, lx, ly, pl)
        post = jnp.sqrt((v1 * v1 + v2 * v2 + v3 * v3) / 3.0)
        _, score = mwt.mwt_align(post, lx, ly)
        return post, score

    ref_post, ref_score = jax.vmap(one)(X, Y, LX, LY)

    np.testing.assert_allclose(
        np.asarray(posts), np.asarray(ref_post), atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(scores), np.asarray(ref_score), atol=2e-3
    )


def _random_posterior_tensor(rng, n, lp):
    """Zero-diagonal symmetric-consistent sparse posterior tensor."""
    s = (rng.random((n, n, lp, lp)) ** 6).astype(np.float32)
    s[s < 0.01] = 0.0
    iu = np.triu_indices(n, 1)
    s[iu[1], iu[0]] = np.swapaxes(s[iu[0], iu[1]], 1, 2)
    s[np.arange(n), np.arange(n)] = 0.0
    return s


def test_sharded_consistency_matches_single_device():
    """The all-gather round over the mesh == the single-device round."""
    from mlprobs_tpu.align import consistency as cons

    mesh = pairs_mesh(8)
    rng = np.random.default_rng(1)
    n, lp = 8, 64
    s = _random_posterior_tensor(rng, n, lp)
    sc, zs, w = cons.dense_relax_coeffs(n)
    want = np.asarray(cons.relax_dense_rounds(
        jnp.asarray(s), jnp.asarray(sc), jnp.asarray(zs),
        jnp.asarray(w), reps=1,
    ))

    shard = pair_sharding(mesh)
    s_dev = jax.device_put(jnp.asarray(s), shard)
    relax = make_sharded_consistency(mesh, num_seqs=n)
    out = np.asarray(relax(
        s_dev,
        jax.device_put(jnp.asarray(sc), shard),
        jax.device_put(jnp.asarray(zs), shard),
        jnp.asarray(w),
    ))
    np.testing.assert_allclose(out, want, atol=1e-6)
    assert ((out == 0) | (out >= 0.01)).all()


def test_production_pipeline_on_mesh(monkeypatch):
    """The PRODUCTION posterior/consistency path sharded over the
    8-device CPU mesh: all_pairs_posteriors matches the single-device
    run up to XLA fusion-order rounding, and the full pipeline on a real family still
    matches the golden output (SURVEY §2.9)."""
    import os
    from pathlib import Path

    import mlprobs_tpu.align.pairwise as pw

    rng = np.random.default_rng(3)
    seqs = [np.asarray(rng.integers(0, 20, n), np.int8)
            for n in (37, 51, 44, 29)]

    def run(multichip):
        monkeypatch.setenv("MLPROBS_MULTICHIP", multichip)
        pw._reset_engine_caches()
        out = {}
        for (i, j), csr, score in pw.all_pairs_posteriors(
            seqs, mode="mix"
        ):
            out[(i, j)] = (csr.toarray(), score)
        return out

    try:
        single = run("0")
        multi = run("1")
    finally:
        pw._reset_engine_caches()
    assert single.keys() == multi.keys()
    for k in single:
        np.testing.assert_allclose(
            single[k][0], multi[k][0], atol=1e-5, rtol=1e-4
        )
        np.testing.assert_allclose(
            single[k][1], multi[k][1], rtol=1e-5, atol=1e-4
        )

    # full pipeline end-to-end on the mesh, scored against golden
    fam = Path("/root/reference/TEST/bali3/in/BB11001")
    gold = Path("/root/reference/output4evaluation/bali3/BB11001")
    if not fam.exists():
        return
    from mlprobs_tpu.bench.quality import sp_tc
    from mlprobs_tpu.core.fasta import read_fasta
    from mlprobs_tpu.core.msa import MSA
    from mlprobs_tpu.pipeline.driver import run_pipeline

    monkeypatch.setenv("MLPROBS_MULTICHIP", "1")
    pw._reset_engine_caches()
    try:
        out, rep = run_pipeline(read_fasta(fam))
    finally:
        pw._reset_engine_caches()
    assert not rep.crash_fallback, rep.error
    sp, tc = sp_tc(out, MSA.from_records(read_fasta(gold)))
    assert sp >= 0.95, (sp, tc)
