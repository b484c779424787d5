"""Wavefront DP engine vs the row-scan oracles (ops/pairhmm, ops/partition).

The wavefront engine (ops/wavefront.py) recomputes the same posteriors
in scaled probability space over anti-diagonals; these tests pin its
numerics to the oracle implementations that are themselves parity-tested
against the reference binaries.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mlprobs_tpu.align import pairwise
from mlprobs_tpu.ops import mwt, pairhmm, partition, wavefront


LP = 24


def _batch(seed=0, b=4, lp=LP):
    rng = np.random.default_rng(seed)
    lx = rng.integers(6, lp + 1, b).astype(np.int32)
    ly = rng.integers(6, lp + 1, b).astype(np.int32)
    X = np.full((b, lp), 20, np.int8)
    Y = np.full((b, lp), 20, np.int8)
    for i in range(b):
        X[i, : lx[i]] = rng.integers(0, 20, lx[i])
        Y[i, : ly[i]] = rng.integers(0, 20, ly[i])
    return (
        jnp.asarray(X), jnp.asarray(Y),
        jnp.asarray(lx), jnp.asarray(ly),
    )


def _run_wavefront(X, Y, lx, ly, models):
    params = {
        "hmm5": pairwise.hmm5_dict(),
        "local": pairwise.local_dict(0.170705),
        "partition": pairwise.partition_dict(),
    }
    tabs_f = {
        m: wavefront.PROB_TABLES[m](params[m], transpose=False)
        for m in models
    }
    tabs_r = {
        m: wavefront.PROB_TABLES[m](params[m], transpose=True)
        for m in models
    }
    b, lp = X.shape
    zero = jnp.zeros((b,), jnp.int32)
    fwd = wavefront.wavefront_forward(
        X, Y, zero, zero, lx, ly, tabs_f, models=models, emit_pre=False
    )
    rev = wavefront.wavefront_forward(
        X[:, ::-1], Y[:, ::-1], lp - lx, lp - ly, lx, ly, tabs_r,
        models=models, emit_pre=True,
    )
    return fwd, rev, params


def _unskew(p_skew):
    """(D, B, W) skewed -> (B, Lp, Lp) 0-based posterior plane (numpy)."""
    p = np.asarray(p_skew)
    D, B, W = p.shape
    lp = W - 1
    out = np.zeros((B, lp, lp), np.float32)
    for i0 in range(lp):
        for j0 in range(lp):
            out[:, i0, j0] = p[i0 + j0 + 2, :, j0 + 1]
    return out


MODELS = ("hmm5", "local", "partition")
ORACLES = {
    "hmm5": pairhmm.hmm5_posterior,
    "local": pairhmm.local_posterior,
    "partition": partition.partition_posterior,
}


@pytest.mark.parametrize("model", MODELS)
def test_wavefront_posterior_matches_oracle(model):
    X, Y, lx, ly = _batch(seed=1)
    fwd, rev, params = _run_wavefront(X, Y, lx, ly, (model,))
    p_skew = wavefront.posterior_skew(fwd, rev, model)
    got = _unskew(p_skew)
    want = np.asarray(
        jax.vmap(ORACLES[model], in_axes=(0, 0, 0, 0, None))(
            X, Y, lx, ly, params[model]
        )
    )
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-5)


def test_wavefront_fused_models_match_single():
    X, Y, lx, ly = _batch(seed=2)
    fwd, rev, _ = _run_wavefront(X, Y, lx, ly, MODELS)
    for model in MODELS:
        fwd1, rev1, _ = _run_wavefront(X, Y, lx, ly, (model,))
        np.testing.assert_allclose(
            np.asarray(wavefront.posterior_skew(fwd, rev, model)),
            np.asarray(wavefront.posterior_skew(fwd1, rev1, model)),
            rtol=1e-6, atol=1e-7,
        )


def test_wavefront_totals_match_oracle():
    X, Y, lx, ly = _batch(seed=3)
    fwd, rev, params = _run_wavefront(X, Y, lx, ly, ("hmm5",))
    ln2 = np.log(2.0)

    def tot_one(x, y, lxi, lyi):
        _, fstates = pairhmm.hmm5_forward(x, y, lxi, lyi, params["hmm5"])
        return jax.scipy.special.logsumexp(
            fstates[lxi] + params["hmm5"]["init"]
        )

    want = np.asarray(
        jax.vmap(tot_one, in_axes=(0, 0, 0, 0))(X, Y, lx, ly)
    )
    got = np.asarray(fwd["log2t"]["hmm5"]) * ln2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the reverse pass computes the same total independently
    got_r = np.asarray(rev["log2t"]["hmm5"]) * ln2
    np.testing.assert_allclose(got_r, want, rtol=1e-4, atol=1e-4)


def test_mwt_skew_matches_rowscan():
    X, Y, lx, ly = _batch(seed=4)
    fwd, rev, _ = _run_wavefront(X, Y, lx, ly, ("hmm5",))
    p_skew = wavefront.posterior_skew(fwd, rev, "hmm5")
    score, nb = wavefront.mwt_skew(p_skew, lx, ly, with_matches=True)

    p_unsk = _unskew(p_skew)
    want_s, want_n = [], []
    for k in range(X.shape[0]):
        dirs, s = mwt.mwt_align(jnp.asarray(p_unsk[k]), lx[k], ly[k])
        want_s.append(float(s))
        want_n.append(int(mwt.count_matches(dirs, lx[k], ly[k])))
    np.testing.assert_allclose(
        np.asarray(score), np.asarray(want_s), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_array_equal(
        np.asarray(nb).astype(int), np.asarray(want_n)
    )


def test_topk_skew_covers_cutoff_entries():
    X, Y, lx, ly = _batch(seed=5)
    fwd, rev, _ = _run_wavefront(X, Y, lx, ly, ("hmm5",))
    p_skew = wavefront.posterior_skew(fwd, rev, "hmm5")
    vals, lanes = wavefront.topk_skew(p_skew, 16, 0.01)
    vals, lanes = np.asarray(vals), np.asarray(lanes)
    p = np.asarray(p_skew)
    # every entry >= cutoff appears (a diagonal has < 16 such entries
    # for these sizes), with its exact value
    D, B, W = p.shape
    for d in range(D):
        for b in range(B):
            want = {
                (j, p[d, b, j]) for j in range(W) if p[d, b, j] >= 0.01
            }
            got = {
                (lanes[d, b, k], vals[d, b, k])
                for k in range(16)
                if vals[d, b, k] > 0
            }
            assert want <= got


def test_all_pairs_posteriors_engines_agree(monkeypatch):
    """The wavefront production path and the row-scan oracle path produce
    equivalent sparse posteriors and identical MWT scores."""
    import mlprobs_tpu.align.pairwise as pw

    monkeypatch.setenv("MLPROBS_NATIVE_ROUTE", "0")

    rng = np.random.default_rng(7)
    seqs = [np.asarray(rng.integers(0, 20, n), np.int8)
            for n in (17, 23, 11)]

    def run(engine):
        monkeypatch.setattr(pw, "_engine", lambda: engine)
        out = {}
        for (i, j), csr, score, nb in pw.all_pairs_posteriors(
            seqs, mode="mix", leave_prob=0.3, with_matches=True
        ):
            out[(i, j)] = (csr.toarray(), score, nb)
        return out

    wfp = run("wavefront")
    scn = run("scan")
    assert wfp.keys() == scn.keys()
    for k in wfp:
        aw, sw, nw = wfp[k]
        as_, ss, ns = scn[k]
        assert ns == nw
        np.testing.assert_allclose(sw, ss, rtol=1e-4, atol=1e-4)
        # supports differ (per-diagonal vs per-row top-k) but shared
        # entries carry the same posterior values
        both = (aw > 0) & (as_ > 0)
        np.testing.assert_allclose(
            aw[both], as_[both], rtol=2e-3, atol=2e-5
        )
        # the strong entries (>= 10 * cutoff) must agree as a set
        strong_w = set(map(tuple, np.argwhere(aw >= 0.1)))
        strong_s = set(map(tuple, np.argwhere(as_ >= 0.1)))
        assert strong_w == strong_s


def test_viterbi_wavefront_matches_rowscan():
    from mlprobs_tpu.ops import viterbi as vit

    X, Y, lx, ly = _batch(seed=8)
    pl = pairwise.local_dict()
    dirs_s, ends_s, score_s = wavefront.viterbi_wavefront(
        X, Y, lx, ly, pl, jnp.asarray(vit.VIT_INIT)
    )
    dirs_s = np.asarray(dirs_s)
    B, lp = X.shape

    vfn = pairwise._viterbi_fn()
    dirs_r, ends_r, score_r = vfn(X, Y, lx, ly, pl)
    dirs_r, ends_r = np.asarray(dirs_r), np.asarray(ends_r)

    np.testing.assert_array_equal(np.asarray(ends_s), ends_r)
    np.testing.assert_allclose(
        np.asarray(score_s), np.asarray(score_r), rtol=1e-5, atol=1e-4
    )
    # direction bits must agree on every cell reachable by a traceback:
    # compare along the actual optimal paths
    from mlprobs_tpu.align.traceback import viterbi_traceback

    for k in range(B):
        li, lj = int(lx[k]), int(ly[k])
        # unskew via strided view
        plane = dirs_s[:, k, :]
        sd, sj = plane.strides
        unsk = np.lib.stride_tricks.as_strided(
            plane, shape=(li + 1, lj + 1), strides=(sd, sd + sj)
        ).copy()
        path_w = viterbi_traceback(unsk, int(ends_s[k]), li, lj)
        path_r = viterbi_traceback(
            dirs_r[k, : li + 1, : lj + 1], int(ends_r[k]), li, lj
        )
        np.testing.assert_array_equal(path_w, path_r)


def test_viterbi_path_stats_matches_host():
    """Device traceback statistics == host traceback + feature loop."""
    from mlprobs_tpu.align.traceback import viterbi_traceback
    from mlprobs_tpu.models import params as mp
    from mlprobs_tpu.ops import viterbi as vit

    X, Y, lx, ly = _batch(seed=9)
    pl = pairwise.local_dict()
    bl = np.asarray(mp.blosum62(), dtype=np.float64)
    dirs_s, ends, _ = wavefront.viterbi_wavefront(
        X, Y, lx, ly, pl, jnp.asarray(vit.VIT_INIT)
    )
    plen, matches, srev = wavefront.viterbi_path_stats(
        dirs_s, ends, X, Y, lx, ly, jnp.asarray(bl, jnp.float32)
    )
    plen, matches = np.asarray(plen), np.asarray(matches)
    srev = np.asarray(srev)
    dirs_np = np.asarray(dirs_s)
    B, lp = X.shape
    Xn, Yn = np.asarray(X), np.asarray(Y)
    for k in range(B):
        li, lj = int(lx[k]), int(ly[k])
        sd, sj = dirs_np[:, k, :].strides
        unsk = np.lib.stride_tricks.as_strided(
            dirs_np[:, k, :], shape=(li + 1, lj + 1), strides=(sd, sd + sj)
        ).copy()
        path = viterbi_traceback(unsk, int(ends[k]), li, lj)
        assert plen[k] == len(path)
        a = Xn[k, np.cumsum(path != 2) - 1]
        b = Yn[k, np.cumsum(path != 1) - 1]
        is_b = path == 0
        assert matches[k] == int(((a == b) & is_b).sum())
        scores = np.where(is_b & (a < 20) & (b < 20), bl[a, b], 0.0)
        scores = np.where(scores < 10, scores, 0.0)
        got = srev[: len(path), k][::-1]
        np.testing.assert_allclose(got, scores, atol=1e-6)


def test_long_pair_class_routes_to_host(monkeypatch):
    """Pairs whose B=1 DP planes exceed the device budget take the
    concurrent host row-scan class (QuickPosteriorStage.cpp:141-154
    'very long' role) and still return correct posteriors."""
    import mlprobs_tpu.align.pairwise as pw

    rng = np.random.default_rng(3)
    seqs = [np.asarray(rng.integers(0, 20, n), np.int8)
            for n in (40, 300, 35)]
    monkeypatch.setenv("MLPROBS_NATIVE_ROUTE", "0")
    monkeypatch.setattr(pw, "_engine", lambda: "wavefront")

    def run():
        return {
            (i, j): (csr.toarray(), score)
            for (i, j), csr, score in pw.all_pairs_posteriors(
                seqs, mode="mix", leave_prob=0.3
            )
        }

    full = run()
    # budget that only fits the 128-residue bucket: the (0,1)/(1,2) pairs
    # (bucket 384) must fall to the host class
    monkeypatch.setattr(pw, "_wf_plane_budget", lambda: 80 * 128 * 128)
    assert not pw._long_pair_budget_ok(40, 300)
    assert pw._long_pair_budget_ok(40, 35)
    mixed = run()
    assert mixed.keys() == full.keys()
    from mlprobs_tpu.utils.stats import GLOBAL as STATS
    assert STATS.timers.get("posterior_long_pairs", 0) >= 2
    for k in full:
        aw, sw = full[k]
        am, sm = mixed[k]
        np.testing.assert_allclose(sm, sw, rtol=5e-4, atol=1e-4)
        both = (aw > 0) & (am > 0)
        np.testing.assert_allclose(aw[both], am[both], rtol=2e-3,
                                   atol=2e-5)


def test_pair_batches_use_per_pair_buckets():
    """A family with one long outlier batches its short pairs in the
    short bucket (PosteriorTasksWave per-task sizing), not the family
    max bucket."""
    import mlprobs_tpu.align.pairwise as pw

    rng = np.random.default_rng(5)
    seqs = [np.asarray(rng.integers(0, 20, n), np.int8)
            for n in (50, 60, 500)]
    pairs = [(0, 1), (0, 2), (1, 2)]
    widths = {}
    for chunk, X, _, _, _ in pw.iter_pair_batches(seqs, pairs):
        for p in chunk:
            widths[p] = X.shape[1]
    assert widths[(0, 1)] == 128
    assert widths[(0, 2)] == 512 and widths[(1, 2)] == 512


def _onehot_lookup(pm, ygrid, xrow):
    """The one-hot einsum lookup the gathers replaced: pm[x, y] per cell."""
    def oh(c):
        return (c[..., None].astype(jnp.int32)
                == jnp.arange(21)).astype(jnp.float32)

    colt = jnp.einsum("bwc,dc->bwd", oh(ygrid), pm,
                      precision=jax.lax.Precision.HIGHEST)
    return jnp.einsum("bwc,bwc->bw", oh(xrow), colt,
                      precision=jax.lax.Precision.HIGHEST)


_ORACLE_POSTERIOR = {
    "hmm5": "hmm5_posterior_oracle",
    "local": "local_posterior_oracle",
    "partition": "partition_posterior_oracle",
}


@pytest.mark.parametrize("model", MODELS)
def test_emission_gather_matches_onehot_and_oracle(model):
    """The exact gathers (wavefront._lane_table / _pick / _class_rows)
    equal the one-hot contraction they replaced, and the wavefront
    posterior built on them matches the literal numpy oracle."""
    from tests import oracle

    X, Y, lx, ly = _batch(seed=11, b=3)
    fwd, rev, params = _run_wavefront(X, Y, lx, ly, (model,))
    pm = wavefront.PROB_TABLES[model](params[model])["pm"]
    ygrid = jnp.concatenate(
        [jnp.full((X.shape[0], 1), wavefront.PAD, Y.dtype), Y], axis=1
    )
    xrow = jnp.roll(ygrid, 3, axis=1)[::-1]        # any (B, W) classes
    got = wavefront._pick(wavefront._lane_table(ygrid, pm), xrow)
    np.testing.assert_array_equal(
        np.asarray(got), np.asarray(_onehot_lookup(pm, ygrid, xrow))
    )
    if model == "hmm5":
        pins = wavefront.hmm5_prob_tables(params["hmm5"])["pins"]
        for k in range(pins.shape[1]):
            np.testing.assert_array_equal(
                np.asarray(wavefront._class_rows(pins, ygrid)[..., k]),
                np.asarray(_onehot_lookup(
                    jnp.broadcast_to(pins[:, k:k + 1], (21, 21)),
                    jnp.zeros_like(ygrid), ygrid)),
            )
    post = _unskew(wavefront.posterior_skew(fwd, rev, model))
    p64 = {k: np.asarray(v, np.float64) for k, v in params[model].items()}
    fn = getattr(oracle, _ORACLE_POSTERIOR[model])
    for b in range(X.shape[0]):
        li, lj = int(lx[b]), int(ly[b])
        want, _ = fn(np.asarray(X[b, :li]), np.asarray(Y[b, :lj]), p64)
        np.testing.assert_allclose(post[b, :li, :lj], want,
                                   rtol=2e-3, atol=2e-5)
