"""Tests for SP/TC scoring, dense-device consistency and aux tools."""
import os

import numpy as np
import scipy.sparse as sp

import jax.numpy as jnp

from mlprobs_tpu.align import consistency as cons
from mlprobs_tpu.bench.quality import column_identity, sp_tc
from mlprobs_tpu.core.msa import MSA
from mlprobs_tpu.pipeline.auxtools import (
    annotation_scores,
    reverse_records,
    unreliable_family,
    write_clustal,
)


def test_sp_tc_identical_alignment():
    m = MSA.from_records([("a", "AR-N"), ("b", "ARCN"), ("c", "-RCN")])
    sp_, tc = sp_tc(m, m)
    assert sp_ == 1.0 and tc == 1.0


def test_sp_tc_detects_shift():
    ref = MSA.from_records([("a", "ARN-"), ("b", "-ARN")])
    test = MSA.from_records([("a", "ARN"), ("b", "ARN")])
    s, t = sp_tc(test, ref)
    assert s == 0.0 and t == 0.0
    assert column_identity(test, ref) == 0.0


def _random_posts(rng, n, lp):
    posts = {}
    dense = np.zeros((n, n, lp, lp), dtype=np.float32)
    for i in range(n):
        for j in range(i + 1, n):
            p = (rng.random((lp, lp)) ** 3).astype(np.float32)
            p[p < 0.01] = 0.0
            posts[(i, j)] = sp.csr_matrix(p)
            dense[i, j] = p
            dense[j, i] = p.T
    return posts, dense


def test_relax_dense_rounds_matches_sparse_oracle():
    """Production device relaxation == the scipy block-matrix oracle."""
    rng = np.random.default_rng(2)
    n, lp = 4, 16
    posts, dense = _random_posts(rng, n, lp)
    sc, zs, w = cons.dense_relax_coeffs(n)
    got = np.asarray(cons.relax_dense_rounds(
        jnp.asarray(dense), jnp.asarray(sc), jnp.asarray(zs),
        jnp.asarray(w), reps=2,
    ))
    want = cons.relax_sparse(posts, [lp] * n, reps=2)
    for (i, j), s in want.items():
        np.testing.assert_allclose(got[i, j], s.toarray(), atol=1e-5)


def test_relax_dense_rounds_weighted_matches_oracle():
    """Weighted device relaxation == relax_sparse_weighted (accept-all)."""
    rng = np.random.default_rng(3)
    n, lp = 5, 12
    posts, dense = _random_posts(rng, n, lp)
    weights = rng.random(n).astype(np.float64) + 0.1
    sc, zs, w = cons.dense_relax_coeffs(n, weights)
    got = np.asarray(cons.relax_dense_rounds(
        jnp.asarray(dense), jnp.asarray(sc), jnp.asarray(zs),
        jnp.asarray(w), reps=1,
    ))
    want = cons.relax_sparse_weighted(posts, [lp] * n, weights, reps=1)
    for (i, j), s in want.items():
        np.testing.assert_allclose(got[i, j], s.toarray(), atol=1e-5)


def test_device_posterior_tensor_consistency_end_to_end():
    """device_posterior_tensor + relax == host posterior + relax_sparse.

    Uses the full-dense cutoff regime on both sides (the device path's
    sparsity semantics — the reference's own, SparseMatrix.h:14)."""
    from mlprobs_tpu.align import pairwise
    from mlprobs_tpu.bench.simulate import simulate_family
    from mlprobs_tpu.core.alphabet import degap, encode

    fam = simulate_family(4, 60, 90, seed=387)
    seqs = [degap(encode(s)) for _, s in fam.records]
    # pin the device path: small families route to the native host
    # engine by default, but this test exercises the tensor machinery
    os.environ["MLPROBS_NATIVE_ROUTE"] = "0"
    try:
        tensor = pairwise.device_posterior_tensor(seqs, "mix", 0.170705)
    finally:
        os.environ.pop("MLPROBS_NATIVE_ROUTE", None)
    assert tensor is not None
    # oracle: CSRs from the same dense tensor, relaxed on host
    lens = [len(s) for s in seqs]
    posts_in = {}
    S = np.asarray(tensor.S)
    for (i, j) in tensor.pairs:
        posts_in[(i, j)] = sp.csr_matrix(S[i, j][: lens[i], : lens[j]])
    want = cons.relax_sparse(
        posts_in, lens, reps=2
    )
    got = tensor.relax_and_extract(reps=2)
    for key, s in want.items():
        np.testing.assert_allclose(
            got[key].toarray(), s.toarray(), atol=2e-5
        )


def test_annotation_scores_range():
    m = MSA.from_records([("a", "ARN"), ("b", "ARN")])
    posts = {(0, 1): sp.csr_matrix(np.eye(3, dtype=np.float32))}
    scores = annotation_scores(m, posts)
    # reference divisor is n*(n-1) over unordered-pair sums
    # (MSA.cpp:2204), so a perfect 2-seq column scores 100
    assert scores.tolist() == [100, 100, 100]


def test_clustal_output_shape():
    m = MSA.from_records([("seqA", "ARN" * 30), ("seqB", "ARN" * 30)])
    text = write_clustal(m)
    assert "seqA" in text and text.count("seqA") == 2  # 90 cols -> 2 blocks


def test_aux_reverse_and_unreliable():
    recs = reverse_records([("b", "ARN"), ("a", "ND")])
    assert recs == [("a", "DN"), ("b", "NRA")]
    assert unreliable_family(np.array([0.1, 0.2, 3.0]), 1.0, 0.5)
    assert not unreliable_family(np.array([2.0, 3.0, 3.0]), 1.0, 0.5)
