"""Probabilistic-consistency transform.

Reference: MSA::DoRelaxation (MSA.cpp:1172-1281):

    P'(x,y) = (2 P(x,y) + sum_{z != x,y} P(x,z) P(z,y)) / N

masked to the original sparsity support and re-thresholded at 0.01.

Two equivalent implementations:

* `relax_sparse` (host): one product of the big (sum(L) x sum(L)) block
  matrix Q with identity diagonal blocks — Q^2 block (i,j) is exactly
  2 P_ij + sum_z P_iz P_zj.  scipy CSR; used by the CPU path and as the
  oracle.
* `relax_dense_rounds` (device): the same contraction as one batched
  matmul over a dense (N, N, Lp, Lp) posterior tensor.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from mlprobs_tpu.utils.stats import GLOBAL as STATS

CUTOFF = 0.01  # SparseMatrix.h:14

# Park-Miller minimal standard generator: the deterministic RNG the
# reference uses identically on host and device so CPU/GPU runs match
# (Common/deterministic_random.h, Kernels/Random.cl).
PM_MOD = 2147483647
PM_MULT = 16807


def parkmiller(seed: int) -> int:
    return (seed * PM_MULT) % PM_MOD


SELECTIVITY_FUNCTIONS = {
    "sum": lambda x, y: x + y,
    "min": min,
    "max": max,
    "avg": lambda x, y: x + y / 2,   # the reference's literal formula
}


def selectivity_filter(kind: str, selectivity: float):
    """Filter shape + coefficients (ConsistencyStage.cpp:35-58)."""
    import math

    if kind == "deterministic":
        a, b = selectivity, 0.0
        return lambda x: 2.0 if x <= a else 0.0
    if kind == "triangle_lowpass":
        a = -1.0
        b = math.sqrt(2.0 * selectivity * (-a))
        return lambda x: a * x + b
    if kind == "triangle_highpass":
        a = 1.0
        b = -1 + math.sqrt(2.0 * selectivity * a)
        return lambda x: a * x + b
    if kind == "triangle_midpass":
        a = 4 * selectivity
        return lambda x: min(a * x, -a * x + a)
    if kind == "homograph_lowpass":
        a = selectivity
        return lambda x: (1 - x) / (a * x + 1)
    raise ValueError(kind)


def z_acceptance(
    distances: np.ndarray,
    i: int,
    j: int,
    seed: int,
    function: str = "max",
    filter_kind: str = "deterministic",
    selectivity: float = 200.0,
) -> list[int]:
    """Accepted intermediate sequences z for pair (i, j).

    Reference-exact stochastic z-filter (ConsistencyStage.cpp:186-221):
    the pair's mt19937-table seed drives the 75-multiplier Lehmer
    stream; z is accepted iff float(seed) * RND_MAX_INV < filter(x).
    `seed` must come from qprand.consistency_seed_matrix.
    """
    from mlprobs_tpu.utils import qprand

    n = distances.shape[0]
    func = SELECTIVITY_FUNCTIONS[function]
    filt = selectivity_filter(filter_kind, selectivity)
    zs = [k for k in range(n) if k not in (i, j)]
    x = np.array(
        [filt(func(distances[i, k], distances[j, k])) for k in zs],
        dtype=np.float32,
    )
    accept = qprand.z_accept_row(seed, x)
    return [k for k, a in zip(zs, accept) if a]


def selectivity_distances(
    mode: str,
    distances: np.ndarray,
    subtree: np.ndarray | None = None,
    selectivity: float = 200.0,
    normalization: str = "no",
) -> np.ndarray:
    """Consistency-distance preparation (ExtendedMSA.cpp:104-177).

    mode: "subtree" (tree subtree distances), "similarity" (the MWT
    distance matrix) or "seed" (all-max matrix with `selectivity`
    mt19937-drawn seed rows zeroed).  normalization: "no", "stochastic"
    (divide by max if > 1), "ranked" (global stable rank desc over all
    n*n entries, / n(n-1), diag preset to max) or "rankedrow" (row-wise
    rank desc / n).
    """
    from mlprobs_tpu.utils import qprand

    n = distances.shape[0]
    if mode == "subtree":
        if subtree is None:
            raise ValueError("subtree mode needs subtree distances")
        cd = np.array(subtree, dtype=np.float32, copy=True)
    elif mode == "similarity":
        cd = np.array(distances, dtype=np.float32, copy=True)
    elif mode == "seed":
        cd = np.full((n, n), np.finfo(np.float32).max, np.float32)
        for s in qprand.seed_selection_ids(n, int(selectivity)):
            cd[s, :] = 0.0
            cd[:, s] = 0.0
    else:
        raise ValueError(mode)

    def rank_desc(flat: np.ndarray) -> np.ndarray:
        # rank_range with std::greater: stable sort ascending by
        # (value, index) under >, i.e. descending value, stable
        order = np.lexsort((np.arange(len(flat)), -flat))
        out = np.empty(len(flat), dtype=np.float32)
        out[order] = np.arange(len(flat), dtype=np.float32)
        return out

    if normalization == "no":
        pass
    elif normalization == "stochastic":
        mx = cd.max()
        if mx > 1.0:
            cd = cd / mx
    elif normalization == "ranked":
        np.fill_diagonal(cd, np.finfo(np.float32).max)
        cd = rank_desc(cd.ravel()).reshape(n, n) / (n * (n - 1))
    elif normalization == "rankedrow":
        np.fill_diagonal(cd, np.finfo(np.float32).max)
        cd = np.stack([rank_desc(row) for row in cd]) / n
    else:
        raise ValueError(normalization)
    return cd.astype(np.float32)


def saturate_weights(weights: np.ndarray,
                     saturation: float = 1e-6) -> np.ndarray:
    """Weight saturation clamp (ExtendedMSA.cpp:178,184)."""
    return np.maximum(np.asarray(weights, np.float64), saturation)


def sparsify(post: np.ndarray, cutoff: float = CUTOFF) -> sp.csr_matrix:
    """Threshold a dense posterior plane into CSR (values >= cutoff)."""
    keep = post >= cutoff
    out = sp.csr_matrix(np.where(keep, post, 0.0))
    out.eliminate_zeros()
    return out


def _block_matrix(
    posts: dict[tuple[int, int], sp.csr_matrix], lengths: list[int]
) -> sp.csr_matrix:
    n = len(lengths)
    blocks: list[list] = [[None] * n for _ in range(n)]
    for i in range(n):
        blocks[i][i] = sp.identity(lengths[i], format="csr")
    for (i, j), s in posts.items():
        blocks[i][j] = s
        blocks[j][i] = s.T.tocsr()
    return sp.bmat(blocks, format="csr")


def relax_sparse(
    posts: dict[tuple[int, int], sp.csr_matrix],
    lengths: list[int],
    reps: int = 2,
    cutoff: float = CUTOFF,
) -> dict[tuple[int, int], sp.csr_matrix]:
    """`reps` rounds of the consistency transform on CSR posteriors.

    Dispatches to the native OpenMP kernel (relax_native) when the
    runtime is available; the scipy block-matrix path below is the
    oracle/fallback."""
    out = relax_native(posts, lengths, reps=reps, cutoff=cutoff)
    if out is not None:
        return out
    n = len(lengths)
    offs = np.concatenate([[0], np.cumsum(lengths)])
    current = posts
    for _ in range(reps):
        q = _block_matrix(current, lengths)
        r = (q @ q) / n
        # mask to the original off-diagonal support
        pattern = _block_matrix(current, lengths)
        pattern.setdiag(0)
        pattern.eliminate_zeros()
        pattern.data[:] = 1.0
        r = r.multiply(pattern).tocsr()
        r.data[r.data < cutoff] = 0.0
        r.eliminate_zeros()
        new = {}
        for (i, j) in current:
            blk = r[offs[i] : offs[i + 1], offs[j] : offs[j + 1]].tocsr()
            new[(i, j)] = blk
        current = new
    return current


def relax_sparse_weighted(
    posts: dict[tuple[int, int], sp.csr_matrix],
    lengths: list[int],
    weights: np.ndarray,
    reps: int = 2,
    selfweight: float = 3.0,
    selectivity: float = 200.0,
    cutoff: float = CUTOFF,
    distances: np.ndarray | None = None,
    seeds: np.ndarray | None = None,
    final_cutoff: float | None = None,
) -> dict[tuple[int, int], sp.csr_matrix]:
    """QuickProbs-style weighted relaxation (ConsistencyStage.cpp:133-259).

    P'_ij = (P_ij + sum_{z in A_ij} (w_z / W_ij) P_iz P_zj) / sumW_ij
    with W_ij = (1 + (selfweight-1) * |A_ij|/selectivity) * (w_i + w_j),
    masked to the original support and re-thresholded.  A_ij is the
    accepted-z set of the stochastic selectivity filter; when
    `distances` is None every z is accepted (the deterministic filter
    below its threshold — the realign-block regime), enabling the fast
    single-block-product path.
    """
    out = relax_native(
        posts, lengths, reps=reps, cutoff=cutoff, weights=weights,
        selfweight=selfweight, selectivity=selectivity,
        distances=distances, seeds=seeds, final_cutoff=final_cutoff,
    )
    if out is not None:
        return out
    if final_cutoff is not None and final_cutoff != cutoff and reps > 0:
        # numFilterings=-1: the last iteration re-sparsifies at 1e-5
        # (ConsistencyStage.cpp:230-259); run it as its own round
        if reps > 1:
            posts = relax_sparse_weighted(
                posts, lengths, weights, reps=reps - 1,
                selfweight=selfweight, selectivity=selectivity,
                cutoff=cutoff, distances=distances, seeds=seeds,
            )
        return relax_sparse_weighted(
            posts, lengths, weights, reps=1, selfweight=selfweight,
            selectivity=selectivity, cutoff=final_cutoff,
            distances=distances, seeds=seeds,
        )
    n = len(lengths)
    offs = np.concatenate([[0], np.cumsum(lengths)])
    w = np.asarray(weights, dtype=np.float64)
    current = posts
    accept_all = distances is None

    for _ in range(reps):
        blocks: list[list] = [[None] * n for _ in range(n)]
        for (i, j), s in current.items():
            blocks[i][j] = s
            blocks[j][i] = s.T.tocsr()
        if accept_all:
            # block matrix with ZERO diagonal (self terms added explicitly)
            q = sp.bmat(blocks, format="csr")
            wdiag = sp.diags(
                np.concatenate(
                    [np.full(lengths[z], w[z]) for z in range(n)]
                )
            )
            r = q @ wdiag @ q
        if not accept_all and seeds is None:
            from mlprobs_tpu.utils import qprand

            seeds = qprand.consistency_seed_matrix(n)
        new = {}
        for (i, j), s in current.items():
            if accept_all:
                accepted = [z for z in range(n) if z not in (i, j)]
            else:
                accepted = z_acceptance(
                    distances, i, j, seed=int(seeds[i, j]),
                    selectivity=selectivity,
                )
            wij = (1.0 + (selfweight - 1.0) * len(accepted) / selectivity)
            wij *= w[i] + w[j]
            sum_w = 1.0 + sum(w[z] for z in accepted) / wij
            if accept_all:
                blk = r[offs[i]:offs[i + 1], offs[j]:offs[j + 1]].tocsr()
            else:
                blk = sp.csr_matrix((lengths[i], lengths[j]))
                for z in accepted:
                    blk = blk + w[z] * (blocks[i][z] @ blocks[z][j])
            out = (s + blk / wij) / sum_w
            out = out.multiply(s > 0).tocsr()
            out.data[out.data < cutoff] = 0.0
            out.eliminate_zeros()
            new[(i, j)] = out
        current = new
    return current


# ---------------------------------------------------------------------------
# Production device relaxation: batched masked matmuls
# ---------------------------------------------------------------------------
#
# Both reference transforms reduce to one parametrised update on a dense
# (N, N, Lp, Lp) posterior tensor S with ZERO diagonal blocks (S_ii = 0
# makes the z != i, j exclusion automatic):
#
#   R_ij = self_coef[i,j] * S_ij
#          + z_scale[i,j] * sum_z w[z] * S_iz @ S_zj
#
# masked to support(S_ij >= cutoff) and re-thresholded — exactly the
# parametrisation of the native OpenMP kernel (relax_native above), so
# the two production engines share their coefficient computation.
#
#   baseMSA DoRelaxation (MSA.cpp:1172-1281):
#       self_coef = 2/N, z_scale = 1/N, w = 1
#   QuickProbs weighted accept-all (ConsistencyStage.cpp:133-259):
#       wij = (1 + (sw-1)(N-2)/sel) * (w_i + w_j)
#       sumW = 1 + (sum(w) - w_i - w_j)/wij
#       self_coef = 1/sumW, z_scale = 1/(wij * sumW), w = weights


def dense_relax_coeffs(
    n: int,
    weights: np.ndarray | None = None,
    selfweight: float = 3.0,
    selectivity: float = 200.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(self_coef (N,N), z_scale (N,N), w (N,)) for relax_dense_rounds."""
    if weights is None:
        sc = np.full((n, n), 2.0 / n, np.float32)
        zs = np.full((n, n), 1.0 / n, np.float32)
        return sc, zs, np.ones(n, np.float32)
    w = np.asarray(weights, np.float64)
    wi = w[:, None] + w[None, :]
    wij = (1.0 + (selfweight - 1.0) * (n - 2) / selectivity) * wi
    sum_w = 1.0 + (w.sum() - wi) / wij
    return (
        (1.0 / sum_w).astype(np.float32),
        (1.0 / (wij * sum_w)).astype(np.float32),
        w.astype(np.float32),
    )


@functools.partial(
    jax.jit, static_argnames=("reps", "cutoff", "final_cutoff")
)
def relax_dense_rounds(S, self_coef, z_scale, w, reps: int = 2,
                       cutoff: float = CUTOFF,
                       final_cutoff: float | None = None):
    """`reps` relaxation rounds on a zero-diagonal (N, N, Lp, Lp) tensor.

    The z-contraction is one weighted batched matmul, pinned to f32
    (Precision.HIGHEST): the thresholds at 0.01 and 1e-5 decide the
    sparsity pattern, and a TF32 product can move an entry across
    either.  The support mask and threshold follow each round (the
    reference masks to the round's input sparsity pattern,
    MSA.cpp:1237-1261).
    `final_cutoff` is the LAST round's re-threshold: QuickProbs'
    numFilterings=-1 default disables filtering on the final iteration
    and re-sparsifies at 1e-5 instead of the posterior cutoff
    (ConsistencyStage.cpp:230-259) — nearly half the reference's final
    entries live below 0.01, so dropping them diverges construction.
    """
    for it in range(reps):
        c = cutoff if (final_cutoff is None or it < reps - 1) \
            else final_cutoff
        prod = jnp.einsum(
            "izab,z,zjbc->ijac", S, w, S,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        r = (self_coef[:, :, None, None] * S
             + z_scale[:, :, None, None] * prod)
        S = jnp.where((S > 0) & (r >= c), r, 0.0)
    return S


def _pack_cells(
    posts: dict[tuple[int, int], sp.csr_matrix], lengths: list[int]
):
    """Flatten all ordered cells (i, j), i != j, into shared CSR pools.

    Lower cells hold transposes, built with numpy lexsort (scipy's
    .T.tocsr() conversion dominated the packing profile).  Returns
    (cell_ptr, cell_dat, indptr_pool, indices_pool, data_pool,
    tperm_off, tperm_pool, pair_list): tperm maps each upper entry to
    its index within the transpose cell's data (the native kernel
    refreshes both orientations between rounds through it).
    """
    n = len(lengths)
    pair_list = sorted(posts.keys())
    cell_ptr = np.zeros(n * n, dtype=np.int64)
    cell_dat = np.zeros(n * n, dtype=np.int64)
    indptrs, indices, datas = [], [], []
    tperms = []
    tperm_off = np.zeros(len(pair_list), dtype=np.int64)
    po = 0
    do = 0

    def put(i, j, indptr, index, data):
        nonlocal po, do
        c = i * n + j
        cell_ptr[c] = po
        cell_dat[c] = do
        indptrs.append(indptr)
        indices.append(index)
        datas.append(data)
        po += len(indptr)
        do += len(data)

    toff = 0
    for p, (i, j) in enumerate(pair_list):
        s = posts[(i, j)]
        li, lj = s.shape
        indptr = np.asarray(s.indptr, np.int32)
        cols = np.asarray(s.indices, np.int32)
        data = np.asarray(s.data, np.float32)
        rows = np.repeat(
            np.arange(li, dtype=np.int32), np.diff(indptr)
        )
        order = np.lexsort((rows, cols))
        tperm = np.empty(len(data), np.int32)
        tperm[order] = np.arange(len(data), dtype=np.int32)
        t_indptr = np.zeros(lj + 1, np.int32)
        t_indptr[1:] = np.cumsum(np.bincount(cols, minlength=lj))
        tperm_off[p] = toff
        toff += len(tperm)
        tperms.append(tperm)
        put(i, j, indptr, cols, data)
        put(j, i, t_indptr, rows[order], data[order])
    z32 = np.zeros(0, np.int32)
    zf = np.zeros(0, np.float32)
    return (
        cell_ptr, cell_dat,
        np.concatenate(indptrs) if indptrs else z32,
        np.concatenate(indices) if indices else z32,
        np.concatenate(datas) if datas else zf,
        tperm_off,
        np.concatenate(tperms) if tperms else z32,
        pair_list,
    )


def relax_native(
    posts: dict[tuple[int, int], sp.csr_matrix],
    lengths: list[int],
    reps: int = 2,
    cutoff: float = CUTOFF,
    weights: np.ndarray | None = None,
    selfweight: float = 3.0,
    selectivity: float = 200.0,
    distances: np.ndarray | None = None,
    seeds: np.ndarray | None = None,
    final_cutoff: float | None = None,
) -> dict[tuple[int, int], sp.csr_matrix] | None:
    """Relaxation rounds via the native OpenMP kernel.

    weights=None selects the plain baseMSA transform
    (R = (2P + sum_z P_iz P_zj)/N, MSA.cpp:1172-1281); otherwise the
    QuickProbs weighted transform with the stochastic z-filter
    (ConsistencyStage.cpp:133-259).  Returns None if the native runtime
    is unavailable (callers fall back to the scipy implementations).
    """
    from mlprobs_tpu.utils import native

    if native.lib() is None:
        return None
    n = len(lengths)
    pair_list = sorted(posts.keys())
    npairs = len(pair_list)
    pair_ij = np.asarray(pair_list, dtype=np.int32)
    self_coef = np.zeros(npairs, dtype=np.float32)
    z_scale = np.zeros(npairs, dtype=np.float32)
    w_eff = np.zeros((npairs, n), dtype=np.float32)

    if weights is None:
        self_coef[:] = 2.0 / n
        z_scale[:] = 1.0 / n
        for p, (i, j) in enumerate(pair_list):
            w_eff[p, :] = 1.0
            w_eff[p, i] = 0.0
            w_eff[p, j] = 0.0
    else:
        w = np.asarray(weights, dtype=np.float64)
        if distances is not None and seeds is None:
            from mlprobs_tpu.utils import qprand

            seeds = qprand.consistency_seed_matrix(n)
        for p, (i, j) in enumerate(pair_list):
            if distances is None:
                accepted = [z for z in range(n) if z not in (i, j)]
            else:
                accepted = z_acceptance(
                    distances, i, j, seed=int(seeds[i, j]),
                    selectivity=selectivity,
                )
            wij = 1.0 + (selfweight - 1.0) * len(accepted) / selectivity
            wij *= w[i] + w[j]
            sum_w = 1.0 + sum(w[z] for z in accepted) / wij
            self_coef[p] = 1.0 / sum_w
            z_scale[p] = 1.0 / (wij * sum_w)
            w_eff[p, accepted] = w[accepted]

    lengths32 = np.asarray(lengths, dtype=np.int32)
    with STATS.timer("native.consistency"):
        cp, cd, ipp, ixp, dap, tpo, tpp, _ = _pack_cells(posts, lengths)
        out = native.relax_all_pairs(
            n, lengths32, cp, cd, ipp, ixp, dap,
            pair_ij, self_coef, z_scale, w_eff, cutoff,
            reps=reps, cutoff_last=final_cutoff
            if final_cutoff is not None else cutoff,
            tperm_off=tpo, tperm_pool=tpp,
        )
    if out is None:
        return None
    new = {}
    for (i, j) in pair_list:
        c = i * n + j
        s = posts[(i, j)]
        start = cd[c]
        data = out[start : start + s.nnz]
        blk = sp.csr_matrix(
            (data, s.indices.copy(), s.indptr.copy()), shape=s.shape
        )
        blk.eliminate_zeros()
        new[(i, j)] = blk
    return new
