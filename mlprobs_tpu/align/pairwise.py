"""All-pairs posterior stage: batched device DP over length buckets.

The reference runs an OpenMP loop over the N(N-1)/2 pairs
(MSA.cpp:926-1013); here pairs are padded into fixed (batch, Lp) buckets
and the whole batch runs as one vmapped row-scan on device — the analogue
of QuickProbs' wave scheduler (QuickPosteriorStage.cpp:107-135) with XLA
managing memory.

Model selection per family identity class (pdoAlign, MSA.cpp:941-1010):
  pid <= 1 : RMS combine of double-affine HMM, partition-function and
             local posteriors  sqrt((v1^2+v2^2+v3^2)/3)
  pid == 2 : local model only
  pid >= 3 : partition function only
"""
from __future__ import annotations

import collections
import functools
import os
from typing import Iterator, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mlprobs_tpu.core.config import DEFAULT as _CFG
from mlprobs_tpu.models import params as mp
from mlprobs_tpu.ops import mwt, pairhmm, partition, viterbi, wavefront
from mlprobs_tpu.utils import devmem
from mlprobs_tpu.utils.stats import GLOBAL as STATS

# engine constants come from the unified config (core/config.py)
LEN_BUCKET = _CFG.engine.length_bucket
MAX_BATCH_ELEMS = _CFG.engine.max_batch_elems
TOPK = _CFG.engine.topk_per_row
CUTOFF = _CFG.aligner.posterior_cutoff   # SparseMatrix.h:14


def _bucket_len(n: int) -> int:
    return max(LEN_BUCKET, -(-n // LEN_BUCKET) * LEN_BUCKET)


def _batch_size(lp: int, num_pairs: int = 0) -> int:
    """Batch depends only on the length bucket so compile shapes stay few."""
    cap = max(1, MAX_BATCH_ELEMS // (lp * lp))
    cap = 1 << (cap.bit_length() - 1)      # round down to a power of two
    if lp > 1024:
        return max(1, min(cap, 256))       # huge pairs: tiny batches
    return max(8, min(cap, 256))


def hmm5_dict():
    p = mp.hmm5_params()
    return {
        "trans": jnp.asarray(p.trans),
        "init": jnp.asarray(p.init),
        "lmatch": jnp.asarray(p.lmatch),
        "lins": jnp.asarray(p.lins),
    }


def local_dict(leave_prob: float | None = None):
    p = mp.hmm_local_params(leave_prob)
    return {
        "trans": jnp.asarray(p.trans),
        "lmatch": jnp.asarray(p.lmatch),
        "lins": jnp.asarray(p.lins),
        "log_stay": jnp.asarray(p.log_stay),
    }


def partition_dict():
    p = mp.partition_params()
    return {
        "lscore": jnp.asarray(p.lscore),
        "lgap_open": jnp.asarray(p.lgap_open),
        "lgap_ext": jnp.asarray(p.lgap_ext),
    }


def partition_qp_dict():
    """QuickProbs partition model (Vtml200; Configuration.cpp:321-333)."""
    p = mp.partition_params_qp()
    return {
        "lscore": jnp.asarray(p.lscore),
        "lgap_open": jnp.asarray(p.lgap_open),
        "lgap_ext": jnp.asarray(p.lgap_ext),
    }


def _row_topk(post):
    """Threshold at CUTOFF then keep the TOPK largest entries per row.

    Mirrors the reference's sparse representation (cutoff 0.01,
    SparseMatrix.h) with QuickProbs' bounded sparse row length
    (PackedSparseMatrix::setSparseRowThreshold).  Returns (vals, idx).
    """
    masked = jnp.where(post >= CUTOFF, post, 0.0)
    vals, idx = jax.lax.top_k(masked, TOPK)
    return vals, idx.astype(jnp.int32)


# Each stage compiles separately and composes on-device (arrays never
# leave HBM between calls): keeps every XLA program medium-sized — a
# fused all-models program takes minutes to compile — and lets the
# single-model programs be shared across modes.


@functools.lru_cache(maxsize=8)
def _model_fn(model: str):
    inner = {
        "hmm5": pairhmm.hmm5_posterior,
        "local": pairhmm.local_posterior,
        "partition": partition.partition_posterior,
    }[model]

    def one(x, y, lx, ly, p):
        return inner(x, y, lx, ly, p)

    return jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0, None)))


@functools.lru_cache(maxsize=8)
def _finalize_fn(num_models: int, with_matches: bool):
    def one(posts, lx, ly):
        if num_models == 1:
            post = posts[0]
        else:
            acc = sum(p * p for p in posts)
            post = jnp.sqrt(acc / num_models)
        dirs, score = mwt.mwt_align(post, lx, ly)
        vals, idx = _row_topk(post)
        if with_matches:
            nb = mwt.count_matches(dirs, lx, ly)
            return vals, idx, score, nb
        return vals, idx, score

    return jax.jit(jax.vmap(one, in_axes=(0, 0, 0)))


_MODE_MODELS = {
    "mix": ("hmm5", "partition", "local"),
    "qp": ("hmm5", "partition"),
    "hmm5": ("hmm5",),
    "local": ("local",),
    "partition": ("partition",),
}

# Posterior engine (MLPROBS_POSTERIOR_ENGINE):
#   "wavefront" — anti-diagonal scaled-probability lax.scan
#                 (ops/wavefront.py), compiled by XLA for the default
#                 backend; the production device path (default).
#   "native"    — the C++/OpenMP host engine (native/mlprobs_native.cpp
#                 posterior_family_run): reference f32 arithmetic, zero
#                 device traffic.  Under "wavefront", families too small
#                 to pay for the device route here too (see _native_route).
#   "scan"      — per-row log-space scans (ops/pairhmm.py); debugging.
_ENGINES = ("wavefront", "native", "scan")


def _accelerator() -> bool:
    """The one platform check: True when JAX's default backend is an
    accelerator (the GPU), False on the CPU backend, where the native
    host engine stands in for the device."""
    return jax.default_backend() != "cpu"


@functools.lru_cache(maxsize=1)
def _engine() -> str:
    env = os.environ.get("MLPROBS_POSTERIOR_ENGINE", "wavefront")
    if env not in _ENGINES:
        raise ValueError(
            f"MLPROBS_POSTERIOR_ENGINE={env!r} is not an engine; "
            f"expected one of {_ENGINES}"
        )
    return env


# Route cost model (the reference's own split: work goes to the
# accelerator only when it pays, QuickPosteriorStage.cpp:141-154).  A
# route covers the family's posterior stage and its consistency rounds.
# Measured warm on one H100 beside 16 host cores (ROADMAP 1.3):
# - device posterior: seconds per anti-diagonal step of one batch, per
#   mode (the scan costs about the same per step whatever the batch's
#   width), at N=212, L~138;
# - native posterior: cells per second per host core, per mode (mean of
#   N=64, L~481 and N=212, L~138; qp with its products rounded one by
#   one, as the device computes them);
# - device relaxation: a dense f32 GEMM of 2 N^3 Lp^3 flops per round
#   (N=64, Lp=512) plus a fixed cost per round (N=4);
# - native relaxation: core-seconds per N^3 x mean length per round.
# Mode "local" was not measured and takes the single-model "partition"
# costs.
_DEVICE_S_PER_DIAGONAL = {"mix": 2.6e-4, "qp": 2.5e-4, "partition": 1.6e-4}
_NATIVE_CELLS_PER_CORE_S = {"mix": 2.9e6, "qp": 2.5e6, "partition": 2.8e6}
_DEVICE_RELAX_FLOPS_PER_S = 4.2e13
_DEVICE_RELAX_S_PER_ROUND = 3.5e-3
_NATIVE_RELAX_CORE_S = 6e-8
_RELAX_ROUNDS = 2


def _mode_cost(table: dict, mode: str) -> float:
    return table.get(mode, table["partition"])


def _native_available() -> bool:
    from mlprobs_tpu.utils import native

    return native.lib() is not None and hasattr(
        native.lib(), "posterior_family_run"
    )


def _family_cells(
    seqs: Sequence[np.ndarray],
    pairs: Sequence[tuple[int, int]] | None = None,
) -> int:
    """Posterior DP grid cells over the family's pairs."""
    if pairs is None:
        n = len(seqs)
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    return sum((len(seqs[i]) + 1) * (len(seqs[j]) + 1) for i, j in pairs)


def _device_seconds(
    seqs: Sequence[np.ndarray], pairs: Sequence[tuple[int, int]],
    mode: str,
) -> float:
    """Predicted device time: the posterior stage (per length bucket,
    batches x anti-diagonals x the cost of one step) and the dense
    relaxation rounds."""
    lens = [len(s) for s in seqs]
    per_bucket = collections.Counter(
        _bucket_len(max(lens[i], lens[j])) for i, j in pairs
    )
    diagonals = sum(
        -(-n // _wf_batch_size(lp)) * (2 * lp + 1)
        for lp, n in per_bucket.items()
    )
    n, lp = len(seqs), _bucket_len(max(lens))
    relax_round = (2.0 * n ** 3 * lp ** 3 / _DEVICE_RELAX_FLOPS_PER_S
                   + _DEVICE_RELAX_S_PER_ROUND)
    return (diagonals * _mode_cost(_DEVICE_S_PER_DIAGONAL, mode)
            + _RELAX_ROUNDS * relax_round)


def _native_seconds(
    seqs: Sequence[np.ndarray], pairs: Sequence[tuple[int, int]],
    mode: str,
) -> float:
    """Predicted native time on this host's cores: the posterior stage
    and the sparse relaxation rounds."""
    cores = os.cpu_count() or 1
    posterior = _family_cells(seqs, pairs) / (
        _mode_cost(_NATIVE_CELLS_PER_CORE_S, mode) * cores
    )
    n = len(seqs)
    mean_len = sum(len(s) for s in seqs) / max(n, 1)
    relax = _RELAX_ROUNDS * _NATIVE_RELAX_CORE_S * n ** 3 * mean_len / cores
    return posterior + relax


def _native_route(
    seqs: Sequence[np.ndarray],
    mode: str,
    pairs: Sequence[tuple[int, int]] | None = None,
) -> bool:
    """True when the whole family (posterior and consistency stages, in
    posterior `mode`) should run on the native host engine.

    On the CPU backend that is every family (the native SIMD engine
    outruns XLA:CPU); on an accelerator, the families whose predicted
    native time is below the device's."""
    eng = _engine()
    if eng == "native":
        return _native_available()
    if eng != "wavefront":
        return False
    if os.environ.get("MLPROBS_NATIVE_ROUTE", "1") == "0":
        return False
    if not _native_available():
        return False
    if not _accelerator():
        return True
    if pairs is None:
        n = len(seqs)
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    return (_native_seconds(seqs, pairs, mode)
            < _device_seconds(seqs, pairs, mode))


def _reset_engine_caches() -> None:
    """Clear engine/mesh-dependent caches (tests and the multi-chip dry
    run toggle MLPROBS_MULTICHIP / MLPROBS_POSTERIOR_ENGINE at runtime)."""
    _engine.cache_clear()
    _mesh.cache_clear()
    _wf_fn.cache_clear()
    _wf_dense_fn.cache_clear()
    _qp_exact_fn.cache_clear()
    _qp_exact_dense_fn.cache_clear()


@functools.lru_cache(maxsize=1)
def _mesh():
    """The production pairs mesh, or None single-device.

    MLPROBS_MULTICHIP: "auto" (default) shards when an accelerator
    backend shows more than one device; "1" forces sharding (the
    CPU-mesh tests); "0" disables.  Sharding the pair batch is pure data
    parallelism (SURVEY §2.9): per-pair DP results match the
    single-device path up to XLA fusion-order rounding."""
    setting = os.environ.get("MLPROBS_MULTICHIP", "auto")
    if setting == "0":
        return None
    ndev = len(jax.devices())
    if ndev < 2:
        return None
    if setting != "1" and not _accelerator():
        return None
    from mlprobs_tpu.parallel.mesh import pairs_mesh

    return pairs_mesh(ndev)


def _shard_pairs(body, mesh, out_axes: tuple[int, ...]):
    """shard_map `body(X, Y, LX, LY)` over the pair axis of all four
    inputs; `out_axes[k]` names the batch axis of output k (0 for
    per-pair scalars, 1 for (D, B, ...) planes).  Captured tables are
    replicated closures.  Per-pair results are independent of the
    sharding, so this is pure data parallelism (equal up to XLA
    fusion-order rounding) (SURVEY §2.9)."""
    from jax.sharding import PartitionSpec as P

    out_specs = tuple(
        P(*([None] * ax + ["pairs"])) for ax in out_axes
    )
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("pairs"),) * 4,
        out_specs=out_specs if len(out_specs) > 1 else out_specs[0],
        check_vma=False,
    )


def _wf_plane_budget() -> int:
    """Device bytes for the wavefront engine's planes.  A mix-mode batch
    holds ~8 (D, B, W) f32 planes (3 models x fwd/rev + combined
    posterior + top-k staging) plus XLA's transients, so batches are
    planned at ~80 bytes per (pair, cell)."""
    return devmem.budget(_CFG.engine.wf_budget_frac)


def _wf_batch_size(lp: int) -> int:
    # honor the budget all the way down to B=1: a floor of 8 puts
    # ~8 full DP planes in device memory regardless of Lp, which
    # overflows it for very long pairs (PosteriorTasksWave.cpp:44-53's
    # long-pair class).  The 256 cap bounds compile time, which scales
    # with the batch dimension.
    cap = max(1, _wf_plane_budget() // (80 * lp * lp))
    cap = 1 << (cap.bit_length() - 1)
    bs = int(min(cap, 256))
    mesh = _mesh()
    if mesh is not None:
        # the sharded batch must split evenly over devices (each holds
        # its own budget, so the global batch scales with the mesh)
        bs = max(bs, mesh.size)
    return bs


def _combined_skew(models, X, Y, LX, LY, tabs_f, tabs_r):
    """(D, B, W) skewed posterior: fwd+rev sweeps, RMS over `models`."""
    b, lp = X.shape
    zero = jnp.zeros((b,), jnp.int32)
    fwd = wavefront.wavefront_forward(
        X, Y, zero, zero, LX, LY, tabs_f,
        models=models, emit_pre=False,
    )
    rev = wavefront.wavefront_forward(
        X[:, ::-1], Y[:, ::-1], lp - LX, lp - LY, LX, LY, tabs_r,
        models=models, emit_pre=True,
    )
    if len(models) == 1:
        return wavefront.posterior_skew(fwd, rev, models[0])
    acc = None
    for m in models:
        p = wavefront.posterior_skew(fwd, rev, m)
        acc = p * p if acc is None else acc + p * p
    return jnp.sqrt(acc / len(models))


def _sparse_out(post, LX, LY, with_matches: bool):
    """(vals, lanes, score[, nb]) from a skewed posterior plane."""
    vals, lanes = wavefront.topk_skew(post, TOPK, CUTOFF)
    if with_matches:
        score, nb = wavefront.mwt_skew(post, LX, LY, with_matches=True)
        return vals, lanes, score, nb
    score = wavefront.mwt_skew(post, LX, LY, with_matches=False)
    return vals, lanes, score


def _dense_out(post, LX, LY):
    """(grid-space dense plane at the cutoff, MWT score)."""
    score = wavefront.mwt_skew(post, LX, LY, with_matches=False)
    dense = wavefront.unskew_posterior(post)
    return jnp.where(dense >= CUTOFF, dense, 0.0), score


def _jit_pairs(run, out_axes: tuple[int, ...]):
    """jit `run(X, Y, LX, LY, tabs_f, tabs_r)`; on a multi-device mesh
    the pair batch is shard_mapped over devices (each runs the engine
    on its local pairs)."""
    mesh = _mesh()
    if mesh is None:
        return jax.jit(run)

    def run_sharded(X, Y, LX, LY, tabs_f, tabs_r):
        def body(x, y, lx, ly):
            return run(x, y, lx, ly, tabs_f, tabs_r)

        return _shard_pairs(body, mesh, out_axes)(X, Y, LX, LY)

    return run_sharded


@functools.lru_cache(maxsize=16)
def _wf_fn(models: tuple[str, ...], with_matches: bool):
    """Wavefront posterior stage: fwd+rev sweeps, RMS combine,
    skew-space MWT (+match count) and per-diagonal top-k."""

    def run(X, Y, LX, LY, tabs_f, tabs_r):
        post = _combined_skew(models, X, Y, LX, LY, tabs_f, tabs_r)
        return _sparse_out(post, LX, LY, with_matches)

    return _jit_pairs(run, (1, 1, 0, 0) if with_matches else (1, 1, 0))


def _wf_tables(mode: str, leave_prob: float | None):
    params = {
        "hmm5": hmm5_dict(),
        "local": local_dict(leave_prob),
        "partition": partition_qp_dict() if mode == "qp"
        else partition_dict(),
    }
    models = _MODE_MODELS[mode]
    tabs_f = {
        m: wavefront.PROB_TABLES[m](params[m], transpose=False)
        for m in models
    }
    tabs_r = {
        m: wavefront.PROB_TABLES[m](params[m], transpose=True)
        for m in models
    }
    return tabs_f, tabs_r


def topk_diag_to_csr(vals: np.ndarray, lanes: np.ndarray, li: int, lj: int):
    """CSR posterior from one pair's per-diagonal top-k (D, K) arrays.

    Skew cell (d, lane j) is grid cell (i, j) = (d - j, j), i.e. the
    0-based posterior entry (i - 1, j - 1).
    """
    import scipy.sparse as sp

    ds, ks = np.nonzero(vals > 0.0)
    j = lanes[ds, ks]
    r = ds - j - 1
    c = j - 1
    ok = (r >= 0) & (r < li) & (c >= 0) & (c < lj)
    return sp.csr_matrix(
        (vals[ds[ok], ks[ok]], (r[ok], c[ok])), shape=(li, lj)
    )


@functools.lru_cache(maxsize=16)
def _wf_dense_fn(models: tuple[str, ...]):
    """Wavefront posterior emitting grid-space dense planes + MWT score.

    Used by the device consistency path: planes never leave device
    memory between the posterior stage and the relaxation contraction."""

    def run(X, Y, LX, LY, tabs_f, tabs_r):
        post = _combined_skew(models, X, Y, LX, LY, tabs_f, tabs_r)
        return _dense_out(post, LX, LY)

    return _jit_pairs(run, (0, 0))


def _qp_exact() -> bool:
    """QuickProbs-exact posterior arithmetic for the realigner role.

    The binary computes its 5-state HMM in f32 log space with
    polynomial approximations of log1p-exp and exp (ScoreType.h), and
    keeps only partition posteriors in [0.001, 1]
    (PartitionFunction.cpp:264-270).  ops/qpx.py replays that
    arithmetic; with it the per-cell posterior gap vs the binary drops
    from ~2e-3 to ~6e-5, which is what keeps the downstream MWT /
    construction tie-breaks aligned.  Default on; MLPROBS_QP_EXACT=0
    reverts mode "qp" to the scaled-probability engines.
    """
    return os.environ.get("MLPROBS_QP_EXACT", "1") != "0"


def _qpx_combined_skew(X, Y, LX, LY, tabs_f, tabs_r):
    """(D, B, W) RMS-combined qp posterior with reference numerics."""
    from mlprobs_tpu.ops import qpx

    b, lp = X.shape
    zero = jnp.zeros((b,), jnp.int32)
    p5 = mp.hmm5_params()
    ph = qpx.hmm5_posterior_qpx(
        X, Y, LX, LY, jnp.asarray(p5.init), jnp.asarray(p5.trans),
        jnp.asarray(p5.lmatch), jnp.asarray(p5.lins),
    )
    fwd = wavefront.wavefront_forward(
        X, Y, zero, zero, LX, LY, tabs_f,
        models=("partition",), emit_pre=False,
    )
    rev = wavefront.wavefront_forward(
        X[:, ::-1], Y[:, ::-1], lp - LX, lp - LY, LX, LY, tabs_r,
        models=("partition",), emit_pre=True,
    )
    pp = wavefront.posterior_skew(fwd, rev, "partition")
    # the reference drops partition posteriors outside [0.001, 1]
    # before the RMS combine (PartitionFunction.cpp:264-270)
    pp = jnp.where(
        (pp >= jnp.float32(0.001)) & (pp <= 1.0), pp, 0.0
    )
    return jnp.sqrt((ph * ph + pp * pp) * jnp.float32(0.5))


@functools.lru_cache(maxsize=4)
def _qp_exact_fn(with_matches: bool):
    """qp-exact twin of _wf_fn: same (vals, lanes, score[, nb])
    contract, posterior numerics matching the QuickProbs binary."""

    def run(X, Y, LX, LY, tabs_f, tabs_r):
        post = _qpx_combined_skew(X, Y, LX, LY, tabs_f, tabs_r)
        return _sparse_out(post, LX, LY, with_matches)

    return _jit_pairs(run, (1, 1, 0, 0) if with_matches else (1, 1, 0))


@functools.lru_cache(maxsize=4)
def _qp_exact_dense_fn():
    """qp-exact twin of _wf_dense_fn: (dense grid plane, score)."""

    def run(X, Y, LX, LY, tabs_f, tabs_r):
        post = _qpx_combined_skew(X, Y, LX, LY, tabs_f, tabs_r)
        return _dense_out(post, LX, LY)

    return _jit_pairs(run, (0, 0))


# Dense on-device consistency: entries kept per posterior row when the
# relaxed tensor is pulled back to host CSR.  Posterior rows sum to <= 1,
# so at most 100 entries can clear the 0.01 cutoff; 64 is lossless in
# practice (and far above the reference's typical row occupancy).
EXTRACT_TOPK = _CFG.engine.extract_topk


def _cons_budget() -> int:
    """Device bytes for the (N, N, Lp, Lp) posterior tensor (see
    EngineConfig.cons_budget_frac for the peak it leaves room for)."""
    return devmem.budget(_CFG.engine.cons_budget_frac)


@functools.lru_cache(maxsize=4)
def _extract_topk_fn():
    def run(planes):
        vals, idx = jax.lax.top_k(planes, EXTRACT_TOPK)
        return vals, idx.astype(jnp.int32)

    return jax.jit(run)


class DevicePosteriorTensor:
    """HBM-resident all-pairs posterior tensor + MWT distances.

    The device production path (SURVEY §2.9): posterior planes are
    computed by the wavefront engine and stay in device memory as a dense
    zero-diagonal (N, N, Lp, Lp) tensor; the consistency relaxation runs
    as batched masked matmuls (MSA.cpp:1172-1360 /
    ConsistencyStage.cpp:133-259 / RelaxationSector.cpp sector tiling),
    and only the final sparse top-k extraction crosses to the host.
    Unlike the host CSR path this feeds the *full* cutoff-thresholded
    posterior (not a top-k subset) through the relaxation — the
    reference's exact sparsity regime (SparseMatrix.h:14).
    """

    def __init__(self, S, pairs, dist, seq_lens):
        self.S = S                  # (N, N, Lp, Lp) jnp, zero diagonal
        self.pairs = pairs
        self.dist = dist            # (N, N) np
        self.seq_lens = seq_lens

    def _extract(self, S) -> dict:
        """Top-k extract the (N, N, Lp, Lp) tensor's pair planes to host
        CSRs (the only device->host crossing of the consistency path)."""
        ii = jnp.asarray([i for i, _ in self.pairs], jnp.int32)
        jj = jnp.asarray([j for _, j in self.pairs], jnp.int32)
        vals, idx = _extract_topk_fn()(S[ii, jj])
        vals = np.asarray(vals)
        idx = np.asarray(idx)
        posts = {}
        for k, (i, j) in enumerate(self.pairs):
            li, lj = self.seq_lens[i], self.seq_lens[j]
            posts[(i, j)] = topk_to_csr(vals[k], idx[k], li, lj)
        return posts

    def extract_csrs(self) -> dict:
        """Host CSRs of the *unrelaxed* posteriors — lets callers that
        must relax on host (stochastic selectivity filter) reuse the
        already-built device tensor instead of recomputing the whole
        posterior stage (QuickPosteriorStage's single build)."""
        return self._extract(self.S)

    def relax_and_extract(
        self,
        weights: np.ndarray | None = None,
        selfweight: float = 3.0,
        selectivity: float = 200.0,
        reps: int = 2,
        final_cutoff: float | None = None,
    ) -> dict:
        """Run `reps` relaxation rounds on device, return host CSRs."""
        from mlprobs_tpu.align import consistency as cons

        n = self.S.shape[0]
        sc_, zs_, w_ = cons.dense_relax_coeffs(
            n, weights, selfweight=selfweight, selectivity=selectivity
        )
        mesh = _mesh()
        with STATS.timer("device.consistency"):
            if mesh is not None:
                S = _relax_sharded(self.S, sc_, zs_, w_, reps, mesh,
                                   final_cutoff=final_cutoff)
            else:
                S = cons.relax_dense_rounds(
                    self.S, jnp.asarray(sc_), jnp.asarray(zs_),
                    jnp.asarray(w_), reps=reps, final_cutoff=final_cutoff,
                )
            return self._extract(S)


def _relax_sharded(S, sc, zs, w, reps: int, mesh,
                   final_cutoff: float | None = None):
    """Dense relaxation rounds with the row axis sharded over the mesh
    (all-gather of z-rows across devices; parallel/sharded.py).  N is padded
    to a mesh multiple with zero rows, which contribute nothing."""
    from mlprobs_tpu.parallel.sharded import make_sharded_consistency

    n = S.shape[0]
    npad = -(-n // mesh.size) * mesh.size
    if npad != n:
        p = npad - n
        S = jnp.pad(S, ((0, p), (0, p), (0, 0), (0, 0)))
        sc = np.pad(sc, ((0, p), (0, p)))
        zs = np.pad(zs, ((0, p), (0, p)))
        w = np.pad(w, (0, p))
    scj, zsj, wj = jnp.asarray(sc), jnp.asarray(zs), jnp.asarray(w)
    for it in range(reps):
        # numFilterings=-1: the last round re-thresholds at final_cutoff,
        # as in consistency.relax_dense_rounds
        c = (CUTOFF if final_cutoff is None or it < reps - 1
             else final_cutoff)
        S = make_sharded_consistency(mesh, num_seqs=npad, cutoff=c)(
            S, scj, zsj, wj
        )
    return S[:n, :n]


def device_posterior_tensor(
    seqs: Sequence[np.ndarray],
    mode: str,
    leave_prob: float | None = None,
    report: dict | None = None,
) -> DevicePosteriorTensor | None:
    """Build the HBM posterior tensor, or None when over budget.

    A None return downgrades the consistency stage to the host path;
    `report` (when given) records *why* — downgrades must never be
    silent (SURVEY §5.5)."""
    if report is None:
        report = {}
    n = len(seqs)
    if n < 3:
        report["consistency_downgrade"] = "tiny_family"
        return None
    if _native_route(seqs, mode):
        # the whole family runs on the native host engine (posterior +
        # OpenMP relaxation)
        report["consistency_downgrade"] = "native_route"
        return None
    lp = _bucket_len(max(len(s) for s in seqs))
    if n * n * lp * lp * 4 > _cons_budget():
        report["consistency_downgrade"] = (
            f"over_budget:{n * n * lp * lp * 4 >> 20}MiB"
        )
        return None
    if _engine() != "wavefront":
        report["consistency_downgrade"] = f"engine:{_engine()}"
        return None

    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    tabs_f, tabs_r = _wf_tables(mode, leave_prob)
    if mode == "qp" and _qp_exact():
        fn = _qp_exact_dense_fn()
    else:
        fn = _wf_dense_fn(_MODE_MODELS[mode])
    plane_chunks = []
    dist = np.zeros((n, n))
    STATS.add(f"device.posterior_cells.{mode}", _family_cells(seqs, pairs))
    with STATS.timer(f"device.posterior.{mode}"):
        for chunk, X, Y, LX, LY in iter_pair_batches(
            seqs, pairs, batch_fn=_wf_batch_size, force_lp=lp
        ):
            dense, score = fn(
                jnp.asarray(X), jnp.asarray(Y), jnp.asarray(LX),
                jnp.asarray(LY), tabs_f, tabs_r,
            )
            plane_chunks.append(dense[: len(chunk)])
            sc = np.asarray(score)
            for k, (i, j) in enumerate(chunk):
                d = 1.0 - sc[k] / min(len(seqs[i]), len(seqs[j]))
                dist[i, j] = dist[j, i] = d
        planes = (
            jnp.concatenate(plane_chunks, axis=0)
            if len(plane_chunks) > 1 else plane_chunks[0]
        )
        ii = jnp.asarray([i for i, _ in pairs], jnp.int32)
        jj = jnp.asarray([j for _, j in pairs], jnp.int32)
        S = jnp.zeros((n, n, lp, lp), jnp.float32)
        S = S.at[ii, jj].set(planes)
        S = S.at[jj, ii].set(jnp.swapaxes(planes, 1, 2))
        S.block_until_ready()
    return DevicePosteriorTensor(
        S, pairs, dist, [len(s) for s in seqs]
    )


def _posterior_fn(mode: str, with_matches: bool = False):
    models = _MODE_MODELS[mode]

    def run(X, Y, LX, LY, p5, pl, pp):
        params = {"hmm5": p5, "local": pl, "partition": pp}
        posts = [
            _model_fn(m)(X, Y, LX, LY, params[m]) for m in models
        ]
        return _finalize_fn(len(models), with_matches)(
            tuple(posts), LX, LY
        )

    return run


@functools.lru_cache(maxsize=8)
def _viterbi_fn():
    def one(x, y, lx, ly, pl):
        return viterbi.viterbi_local(x, y, lx, ly, pl)

    return jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0, None)))


def _pad_to(seq: np.ndarray, lp: int) -> np.ndarray:
    out = np.full(lp, 20, dtype=np.int8)
    out[: len(seq)] = seq
    return out


def iter_pair_batches(
    seqs: Sequence[np.ndarray], pairs: Sequence[tuple[int, int]],
    batch_fn=None, force_lp: int | None = None,
) -> Iterator[tuple[list[tuple[int, int]], np.ndarray, np.ndarray,
                    np.ndarray, np.ndarray]]:
    """Yield (pair_chunk, X, Y, LX, LY) padded device batches.

    Pairs are grouped by their OWN 128-residue length bucket — the
    reference's per-task wave sizing (PosteriorTasksWave.cpp:14-71) —
    so a family with one long outlier no longer pads every pair to the
    outlier's bucket.  Batch shapes stay (B(lp), lp) with lp a bucket
    multiple, shared across families: a padded batch wastes
    milliseconds of device time, while every new shape costs a fresh
    XLA compile (amortised only by the persistent cache).
    KernelFactory's binary cache plays the same role in the reference
    (KernelFactory.cpp:38-60).
    """
    if not pairs:
        return
    lens = [len(s) for s in seqs]
    buckets: dict[int, list[tuple[int, int]]] = {}
    for i, j in pairs:
        # force_lp pins every pair to one bucket — consumers that build
        # a uniform dense tensor (device_posterior_tensor) need equal
        # plane shapes across batches
        lp = (force_lp if force_lp is not None
              else _bucket_len(max(lens[i], lens[j])))
        buckets.setdefault(lp, []).append((i, j))
    for lp in sorted(buckets):
        group = buckets[lp]
        bs = (batch_fn(lp) if batch_fn is not None
              else _batch_size(lp, len(group)))
        padded: dict[int, np.ndarray] = {}

        def pad(k: int) -> np.ndarray:
            if k not in padded:
                padded[k] = _pad_to(seqs[k][:lp], lp)
            return padded[k]

        for start in range(0, len(group), bs):
            chunk = group[start : start + bs]
            n = len(chunk)
            X = np.stack([pad(i) for i, _ in chunk]
                         + [pad(chunk[0][0])] * (bs - n))
            Y = np.stack([pad(j) for _, j in chunk]
                         + [pad(chunk[0][1])] * (bs - n))
            LX = np.array([lens[i] for i, _ in chunk] + [1] * (bs - n),
                          dtype=np.int32)
            LY = np.array([lens[j] for _, j in chunk] + [1] * (bs - n),
                          dtype=np.int32)
            yield chunk, X, Y, LX, LY


def topk_to_csr(vals: np.ndarray, idx: np.ndarray, li: int, lj: int):
    """Host-side CSR reconstruction of a device top-k sparse posterior."""
    import scipy.sparse as sp

    vals = vals[:li]
    idx = idx[:li]
    keep = vals > 0.0
    rows = np.repeat(np.arange(li), keep.sum(axis=1))
    cols = idx[keep]
    data = vals[keep]
    in_range = cols < lj
    return sp.csr_matrix(
        (data[in_range], (rows[in_range], cols[in_range])), shape=(li, lj)
    )


def all_pairs_posteriors(
    seqs: Sequence[np.ndarray],
    mode: str,
    leave_prob: float | None = None,
    pairs: Sequence[tuple[int, int]] | None = None,
    with_matches: bool = False,
) -> Iterator[tuple]:
    """Yield ((i, j), sparse posterior csr (li, lj), mwt_score[, n_matches])
    per pair."""
    n = len(seqs)
    if pairs is None:
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    if _native_route(seqs, mode, pairs):
        yield from _all_pairs_posteriors_native(
            seqs, mode, leave_prob, pairs, with_matches
        )
        return
    if _engine() == "wavefront":
        yield from _all_pairs_posteriors_wf(
            seqs, mode, leave_prob, pairs, with_matches
        )
        return
    p5, pl = hmm5_dict(), local_dict(leave_prob)
    pp = partition_qp_dict() if mode == "qp" else partition_dict()
    fn = _posterior_fn(mode, with_matches)
    for chunk, X, Y, LX, LY in iter_pair_batches(seqs, pairs):
        out = fn(
            jnp.asarray(X), jnp.asarray(Y), jnp.asarray(LX),
            jnp.asarray(LY), p5, pl, pp
        )
        out = [np.asarray(o) for o in out]
        vals, idx, score = out[:3]
        for k, (i, j) in enumerate(chunk):
            li, lj = len(seqs[i]), len(seqs[j])
            csr = topk_to_csr(vals[k], idx[k], li, lj)
            if with_matches:
                yield (i, j), csr, float(score[k]), int(out[3][k])
            else:
                yield (i, j), csr, float(score[k])


def native_tables(mode: str, leave_prob: float | None):
    """Plain-numpy log tables for the native host engine."""
    p5 = mp.hmm5_params()
    pl = mp.hmm_local_params(leave_prob)
    pp = (mp.partition_params_qp() if mode == "qp"
          else mp.partition_params())
    h5 = {"init": p5.init, "trans": p5.trans,
          "lmatch": p5.lmatch, "lins": p5.lins}
    lo = {"trans": pl.trans, "lmatch": pl.lmatch, "lins": pl.lins,
          "log_stay": float(pl.log_stay)}
    pt = {"lscore": pp.lscore, "lgap_open": float(pp.lgap_open),
          "lgap_ext": float(pp.lgap_ext)}
    return h5, lo, pt


def _all_pairs_posteriors_native(seqs, mode, leave_prob, pairs,
                                 with_matches):
    """All pairs on the C++/OpenMP engine; same yield contract as the
    device paths (PosteriorStage.cpp:94-196 role, zero device traffic)."""
    from mlprobs_tpu.utils import native

    h5, lo, pt = native_tables(mode, leave_prob)
    with STATS.timer("native.posterior"):
        out = native.posterior_family(
            list(seqs), list(pairs), mode, h5, lo, pt,
            cutoff=CUTOFF, with_matches=with_matches,
        )
    if out is None:  # lost the runtime mid-flight: device fallback
        yield from _all_pairs_posteriors_wf(
            seqs, mode, leave_prob, pairs, with_matches
        )
        return
    STATS.add("posterior_native_pairs", len(pairs))
    csrs, scores, matches = out
    for k, (i, j) in enumerate(pairs):
        if with_matches:
            yield (i, j), csrs[k], float(scores[k]), int(matches[k])
        else:
            yield (i, j), csrs[k], float(scores[k])


def _long_pair_budget_ok(li: int, lj: int) -> bool:
    """A pair fits the device wavefront path iff a B=1 batch of its
    bucket keeps the DP planes inside the HBM budget."""
    lp = _bucket_len(max(li, lj))
    return 80 * lp * lp <= _wf_plane_budget()


def _host_long_pairs(seqs, long_pairs, mode, leave_prob, with_matches):
    """Very-long pairs on the host CPU backend, row-scan engine.

    The reference runs pairs whose DP layers exceed the device budget
    on a concurrent CPU thread (QuickPosteriorStage.cpp:141-154,
    PosteriorTasksWave.cpp:44-53 'very long' class); this is the same
    class, computed with the log-space row scans on the CPU PJRT
    backend while the chip processes the normal waves.
    """
    import jax as _jax

    cpu = _jax.local_devices(backend="cpu")[0]
    results = []
    with _jax.default_device(cpu):
        if mode == "qp" and _qp_exact():
            tabs_f, tabs_r = _wf_tables(mode, leave_prob)
            fn = _qp_exact_fn(with_matches)
            for chunk, X, Y, LX, LY in iter_pair_batches(
                seqs, long_pairs, batch_fn=lambda lp: 1
            ):
                out = [np.asarray(o) for o in fn(
                    jnp.asarray(X), jnp.asarray(Y), jnp.asarray(LX),
                    jnp.asarray(LY), tabs_f, tabs_r,
                )]
                vals, lanes, score = out[:3]
                for k, (i, j) in enumerate(chunk):
                    li, lj = len(seqs[i]), len(seqs[j])
                    csr = topk_diag_to_csr(vals[:, k], lanes[:, k],
                                           li, lj)
                    rest = ((int(out[3][k]),) if with_matches else ())
                    results.append(((i, j), csr, float(score[k]))
                                   + rest)
            return results
        p5, pl = hmm5_dict(), local_dict(leave_prob)
        pp = partition_qp_dict() if mode == "qp" else partition_dict()
        fn = _posterior_fn(mode, with_matches)
        for chunk, X, Y, LX, LY in iter_pair_batches(
            seqs, long_pairs, batch_fn=lambda lp: 1
        ):
            out = fn(
                jnp.asarray(X), jnp.asarray(Y), jnp.asarray(LX),
                jnp.asarray(LY), p5, pl, pp
            )
            out = [np.asarray(o) for o in out]
            vals, idx, score = out[:3]
            for k, (i, j) in enumerate(chunk):
                li, lj = len(seqs[i]), len(seqs[j])
                csr = topk_to_csr(vals[k], idx[k], li, lj)
                if with_matches:
                    results.append(((i, j), csr, float(score[k]),
                                    int(out[3][k])))
                else:
                    results.append(((i, j), csr, float(score[k])))
    return results


def _all_pairs_posteriors_wf(seqs, mode, leave_prob, pairs, with_matches):
    tabs_f, tabs_r = _wf_tables(mode, leave_prob)
    if mode == "qp" and _qp_exact():
        fn = _qp_exact_fn(with_matches)
    else:
        fn = _wf_fn(_MODE_MODELS[mode], with_matches)
    long_pairs = [
        (i, j) for i, j in pairs
        if not _long_pair_budget_ok(len(seqs[i]), len(seqs[j]))
    ]
    future = None
    if long_pairs:
        from concurrent.futures import ThreadPoolExecutor

        STATS.add("posterior_long_pairs", len(long_pairs))
        pairs = [p for p in pairs if p not in set(long_pairs)]
        pool = ThreadPoolExecutor(1)
        future = pool.submit(
            _host_long_pairs, seqs, long_pairs, mode, leave_prob,
            with_matches,
        )
    for chunk, X, Y, LX, LY in iter_pair_batches(
        seqs, pairs, batch_fn=_wf_batch_size
    ):
        out = fn(
            jnp.asarray(X), jnp.asarray(Y), jnp.asarray(LX),
            jnp.asarray(LY), tabs_f, tabs_r,
        )
        out = [np.asarray(o) for o in out]
        vals, lanes, score = out[:3]
        for k, (i, j) in enumerate(chunk):
            li, lj = len(seqs[i]), len(seqs[j])
            csr = topk_diag_to_csr(vals[:, k], lanes[:, k], li, lj)
            if with_matches:
                yield (i, j), csr, float(score[k]), int(out[3][k])
            else:
                yield (i, j), csr, float(score[k])
    if future is not None:
        yield from future.result()
        pool.shutdown()


def _unskew_dirs_batch(dirs_skew: np.ndarray) -> np.ndarray:
    """(D, B, W) skewed int8 planes -> (B, W, W) padded direction grids.

    unskew[i, j] = skew[i + j, j]: a strided view per pair (row stride
    sd, column stride sd + sj), materialised once per batch.
    """
    D, B, W = dirs_skew.shape
    sd, sb, sj = dirs_skew.strides
    out = np.empty((B, W, W), np.int8)
    for k in range(B):
        out[k] = np.lib.stride_tricks.as_strided(
            dirs_skew[:, k, :], shape=(W, W), strides=(sd, sd + sj)
        )
    return out


def viterbi_batches(
    seqs: Sequence[np.ndarray],
    pairs: Sequence[tuple[int, int]],
) -> Iterator[tuple[list[tuple[int, int]], np.ndarray, np.ndarray]]:
    """Yield (pair_chunk, dirs (nb, W, W) int8, end_states (nb,)) batches.

    Directions use the packed-bit layout of ops/viterbi.viterbi_local,
    unskewed to padded (W, W) grids regardless of engine.
    """
    pl = local_dict()
    if _engine() == "wavefront":
        vinit = jnp.asarray(viterbi.VIT_INIT)
        for chunk, X, Y, LX, LY in iter_pair_batches(
            seqs, pairs, batch_fn=_wf_batch_size
        ):
            dirs_s, ends, _ = wavefront.viterbi_wavefront(
                jnp.asarray(X), jnp.asarray(Y), jnp.asarray(LX),
                jnp.asarray(LY), pl, vinit,
            )
            nb = len(chunk)
            dirs = _unskew_dirs_batch(np.asarray(dirs_s))[:nb]
            yield chunk, dirs, np.asarray(ends)[:nb]
        return
    fn = _viterbi_fn()
    for chunk, X, Y, LX, LY in iter_pair_batches(seqs, pairs):
        dirs, end_state, _ = fn(
            jnp.asarray(X), jnp.asarray(Y), jnp.asarray(LX),
            jnp.asarray(LY), pl
        )
        nb = len(chunk)
        yield chunk, np.asarray(dirs)[:nb], np.asarray(end_state)[:nb]


def viterbi_stat_batches(
    seqs: Sequence[np.ndarray],
    pairs: Sequence[tuple[int, int]],
    blosum: np.ndarray,
) -> Iterator[tuple[list[tuple[int, int]], np.ndarray, np.ndarray,
                    np.ndarray]]:
    """Device-resident Viterbi + traceback feature statistics.

    Yields (pair_chunk, path_len (nb,), matches (nb,),
    scores_rev (2*Lp, nb)) — the (D, B, W) direction planes never leave
    the device (they are consumed by wavefront.viterbi_path_stats):
    only per-pair scalars cross to the host.  Wavefront engine only.
    """
    pl = local_dict()
    vinit = jnp.asarray(viterbi.VIT_INIT)
    bl = jnp.asarray(blosum, jnp.float32)
    mesh = _mesh()

    def body(x, y, lx, ly):
        dirs_s, ends, _ = wavefront.viterbi_wavefront(
            x, y, lx, ly, pl, vinit
        )
        return wavefront.viterbi_path_stats(
            dirs_s, ends, x, y, lx, ly, bl
        )

    stats_fn = (
        body if mesh is None else _shard_pairs(body, mesh, (0, 0, 1))
    )
    for chunk, X, Y, LX, LY in iter_pair_batches(
        seqs, pairs, batch_fn=_wf_batch_size
    ):
        plen, matches, scores_rev = stats_fn(
            jnp.asarray(X), jnp.asarray(Y),
            jnp.asarray(LX), jnp.asarray(LY),
        )
        nb = len(chunk)
        yield (
            chunk, np.asarray(plen)[:nb], np.asarray(matches)[:nb],
            np.asarray(scores_rev)[:, :nb],
        )


def all_pairs_viterbi(
    seqs: Sequence[np.ndarray],
    pairs: Sequence[tuple[int, int]] | None = None,
) -> Iterator[tuple[tuple[int, int], np.ndarray, int]]:
    """Yield ((i, j), packed direction matrix, end_state) per pair."""
    n = len(seqs)
    if pairs is None:
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    for chunk, dirs, ends in viterbi_batches(seqs, pairs):
        for k, (i, j) in enumerate(chunk):
            li, lj = len(seqs[i]), len(seqs[j])
            yield (i, j), dirs[k, : li + 1, : lj + 1], int(ends[k])
