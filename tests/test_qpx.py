"""QuickProbs-exact posterior arithmetic (ops/qpx.py).

The binary computes its 5-state HMM in f32 log space with polynomial
approximations (ScoreType.h LOOKUP_FLOAT / EXP); qpx replays that
arithmetic so mode-"qp" posteriors land within ~1e-4 of the binary's.
Validated here against (a) the approximations' published fit ranges,
(b) an exact log-space oracle within the fit-error bound, and (c) the
scaled-probability engine on random pairs.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlprobs_tpu.align import pairwise  # noqa: E402
from mlprobs_tpu.models import params as mp  # noqa: E402
from mlprobs_tpu.ops import qpx  # noqa: E402


def test_lookup_float_matches_log1pexp():
    x = np.linspace(0.0, 7.5, 4001, dtype=np.float32)
    got = np.asarray(qpx.lookup_float(jnp.asarray(x)))
    want = np.log1p(np.exp(x.astype(np.float64)))
    # the reference piecewise-cubic fit error is ~2e-4 — we must match
    # the POLYNOMIAL, which itself deviates from exact log1p-exp
    assert np.abs(got - want).max() < 5e-4


def test_exp_ref_matches_exp():
    x = np.linspace(-16.0, 0.0, 4001, dtype=np.float32)
    got = np.asarray(qpx.exp_ref(jnp.asarray(x)))
    want = np.exp(x.astype(np.float64))
    assert np.abs(got - want).max() < 5e-4
    # zero below the underflow branch, exact exp above 0
    assert float(qpx.exp_ref(jnp.float32(-17.0))) == 0.0


_LOOKUP = [(1.0, (-0.009350833524763, 0.130659527668286,
                  0.498799810682272, 0.693203116424741)),
           (2.5, (-0.014532321752540, 0.139942324101744,
                  0.495635523139337, 0.692140569840976)),
           (4.5, (-0.004605031767994, 0.063427417320019,
                  0.695956496475118, 0.514272634594009)),
           (np.inf, (-0.000458661602210, 0.009695946122598,
                     0.930734667215156, 0.168037164329057))]


def _plain_horner(coeffs, x):
    """Numpy f32 Horner: every product and sum rounded on its own."""
    acc = np.float32(coeffs[0]) * x
    for c in coeffs[1:-1]:
        acc = (acc + np.float32(c)) * x
    return acc + np.float32(coeffs[-1])


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (1.0, 2.5), (2.5, 4.5),
                                   (4.5, 7.5)])
def test_lookup_float_rounds_every_product(lo, hi):
    """XLA:CPU would contract each multiply-add into an FMA, XLA:GPU does
    not; lookup_float must give the same f32 values as plain rounding
    (the GPU's and the native engine's) on the CPU too."""
    x = np.random.default_rng(3).uniform(lo, hi, 20000).astype(np.float32)
    got = np.asarray(jax.jit(qpx.lookup_float)(jnp.asarray(x)))
    want = np.select([x <= b for b, _ in _LOOKUP],
                     [_plain_horner(c, x) for _, c in _LOOKUP])
    np.testing.assert_array_equal(got, want)


def test_log_add_absorbs_log_zero():
    v = jnp.float32(-3.25)
    assert float(qpx.log_add(v, jnp.float32(qpx.LOG_ZERO))) == float(v)
    assert float(qpx.log_add(jnp.float32(qpx.LOG_ZERO), v)) == float(v)
    z = qpx.log_add(jnp.float32(qpx.LOG_ZERO),
                    jnp.float32(qpx.LOG_ZERO))
    assert float(z) == float(qpx.LOG_ZERO)


def _random_pairs(seed, n, lens):
    rng = np.random.default_rng(seed)
    return [np.asarray(rng.integers(0, 20, k), np.int8) for k in lens]


def test_hmm5_qpx_close_to_exact_engine():
    """The approximate-arithmetic posterior must sit within the
    accumulated fit-error envelope of the exact scaled engine."""
    from mlprobs_tpu.ops import wavefront

    seqs = _random_pairs(11, 2, (45, 57))
    lp = 128
    X = np.full((1, lp), 20, np.int8)
    Y = np.full((1, lp), 20, np.int8)
    X[0, : len(seqs[0])] = seqs[0]
    Y[0, : len(seqs[1])] = seqs[1]
    LX = jnp.asarray([len(seqs[0])], jnp.int32)
    LY = jnp.asarray([len(seqs[1])], jnp.int32)
    p5 = mp.hmm5_params()
    ph = np.asarray(qpx.hmm5_posterior_qpx(
        jnp.asarray(X), jnp.asarray(Y), LX, LY,
        jnp.asarray(p5.init), jnp.asarray(p5.trans),
        jnp.asarray(p5.lmatch), jnp.asarray(p5.lins),
    ))[:, 0]
    tabs_f, tabs_r = pairwise._wf_tables("hmm5", None)
    zero = jnp.zeros((1,), jnp.int32)
    fwd = wavefront.wavefront_forward(
        jnp.asarray(X), jnp.asarray(Y), zero, zero, LX, LY, tabs_f,
        models=("hmm5",), emit_pre=False,
    )
    rev = wavefront.wavefront_forward(
        jnp.asarray(X[:, ::-1]), jnp.asarray(Y[:, ::-1]),
        lp - LX, lp - LY, LX, LY, tabs_r,
        models=("hmm5",), emit_pre=True,
    )
    pe = np.asarray(wavefront.posterior_skew(fwd, rev, "hmm5"))[:, 0]
    pe = pe[: ph.shape[0], : ph.shape[1]]
    # same support and values within the accumulated polynomial error
    assert np.abs(ph - pe).max() < 5e-3
    strong_a = set(map(tuple, np.argwhere(ph >= 0.1)))
    strong_b = set(map(tuple, np.argwhere(pe >= 0.1)))
    assert strong_a == strong_b


def test_qp_exact_posteriors_csr_contract(monkeypatch):
    """all_pairs_posteriors in qp mode returns well-formed CSRs and
    scores through the qp-exact route."""
    monkeypatch.setattr(pairwise, "_engine", lambda: "wavefront")
    monkeypatch.setenv("MLPROBS_QP_EXACT", "1")
    seqs = _random_pairs(7, 3, (30, 41, 36))
    out = {}
    for (i, j), csr, score in pairwise.all_pairs_posteriors(
        seqs, mode="qp"
    ):
        assert csr.shape == (len(seqs[i]), len(seqs[j]))
        assert np.isfinite(score)
        assert float(csr.toarray().max()) <= 1.0 + 1e-6
        out[(i, j)] = csr
    assert len(out) == 3
