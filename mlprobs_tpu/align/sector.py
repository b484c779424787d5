"""Sector-tiled consistency relaxation for families over the dense gate.

The dense device path (align/consistency.relax_dense_rounds) needs the
whole (N, N, Lp, Lp) posterior tensor resident, within the dense
tensor's share of device memory.  Large families blow that gate; the
reference handles them on GPU by tiling the pair matrix into *sectors*
and streaming sparse sector data through device memory
(RelaxationSector.cpp:14-60,
QuickConsistencyStage.cpp:88-215).  This is the dense-GEMM formulation:

* Host CSR posteriors are flattened once into COO row *panels*:
  panel I = all ordered cells (i, z), i in block I, z in 0..N-1.
* Per sector (I, J), the two panels are scattered into dense
  (b, N, Lp, Lp) tensors on device and the z-contraction

      R_ij = self_coef[i,j] * S_ij
             + z_scale[i,j] * sum_z w_z * S_iz @ S_zj

  runs as ONE f32 GEMM of shape (b*Lp, N*Lp) x (N*Lp, b*Lp):
  S_zj[b, c] = S_jz[c, b], so the contraction over (z, b) uses panel J
  directly — einsum("izab,jzcb->ijac") — no transposed copy.
* The result is masked to support(S_ij >= cutoff), re-thresholded, and
  leaves the device as a per-row top-k — the only device->host crossing.
* Multiple rounds re-sparsify between sweeps exactly like the
  reference's iteration-dependent cutoff pass (ConsistencyStage.cpp:257).

Same coefficient parametrisation as relax_dense_rounds /
the native OpenMP kernel, so it supports both the plain baseMSA
transform (MSA.cpp:1172-1281) and QuickProbs' weighted accept-all
regime.  The stochastic per-pair z-filter is NOT expressible as a
single GEMM; those families stay on the host path (callers check
`supported`).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from mlprobs_tpu.core.config import DEFAULT as _CFG
from mlprobs_tpu.utils import devmem

CUTOFF = 0.01


class SectorOverBudget(RuntimeError):
    """The sector plan cannot fit the device budget at any batch size;
    callers must demote to the host relaxation path BEFORE launching."""


def _sector_peak_bytes(b: int, n: int, lp: int, k: int) -> int:
    """Peak live device bytes of one sector step at pair-block size `b`."""
    panel = 4 * b * n * lp * lp          # f32 (b, N, Lp, Lp)
    block = 4 * b * b * lp * lp          # f32 (b, b, Lp, Lp)
    topk = 2 * 4 * b * b * lp * k
    # panels i + j_w + one scatter-copy transient; s_ij + prod + masked r
    return 3 * panel + 3 * block + topk


def _pow2ceil(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


@functools.lru_cache(maxsize=8)
def _densify_fn(b: int, n: int, lp: int, nnz_pad: int):
    """Scatter a padded COO slice into a dense (b, N, Lp, Lp) panel.

    Padding entries carry value 0.0 at linear index 0 — scatter-add
    keeps them harmless."""

    def run(lin_idx, vals):
        flat = jnp.zeros((b * n * lp * lp,), jnp.float32)
        flat = flat.at[lin_idx].add(vals)
        return flat.reshape(b, n, lp, lp)

    return jax.jit(run)


@functools.lru_cache(maxsize=8)
def _sector_fn(b: int, n: int, lp: int, k: int):
    """One sector's relaxation: GEMM + self term + mask + top-k."""

    def run(panel_i, panel_j_w, s_ij, sc, zs, cutoff):
        # prod[i, j, a, c] = sum_{z, b} S_iz[a, b] * w_z * S_jz[c, b]
        # pinned to f32 like relax_dense_rounds: the cutoffs decide
        # the sparsity pattern
        prod = jnp.einsum(
            "izab,jzcb->ijac", panel_i, panel_j_w,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        r = sc[:, :, None, None] * s_ij + zs[:, :, None, None] * prod
        r = jnp.where((s_ij > 0) & (r >= cutoff), r, 0.0)
        vals, idx = jax.lax.top_k(r, k)
        return vals, idx.astype(jnp.int32)

    return jax.jit(run)


class SectorRelaxer:
    """Relaxation rounds over host CSR posteriors via device sectors."""

    def __init__(
        self,
        lengths: list[int],
        budget: int | None = None,
        extract_topk: int | None = None,
    ):
        self.n = len(lengths)
        self.lengths = lengths
        # 128-multiple bucket (not pow2): a 629 -> 1024 rounding would
        # cost ~4x the GEMM flops
        self.lp = -(-max(128, max(lengths)) // 128) * 128
        budget = int(budget or devmem.budget(
            _CFG.engine.sector_budget_frac))
        self.k = int(extract_topk or _CFG.engine.sector_extract_topk)
        # Honest peak-memory accounting (the QuickPosteriorStage.cpp:107-135
        # contract: size the wave so it FITS, never launch-and-die).
        # Live at the einsum: panel_i + panel_j_w (b*N*Lp^2 each), one
        # transient scatter copy during _densify, s_ij + prod + the
        # masked result (b^2*Lp^2 each).  Counting only the two panels
        # picks b=16 at N=142, Lp=640, whose s_ij alone is 6.7 GB.
        self.b = 0
        for b in (128, 64, 32, 16, 8, 4, 2, 1):
            if b > self.n and b != 1:
                continue
            peak = _sector_peak_bytes(b, self.n, self.lp, self.k)
            if peak <= budget:
                self.b = b
                break
        if self.b == 0:
            raise SectorOverBudget(
                f"sector relaxation cannot fit device budget even at b=1 "
                f"(N={self.n}, Lp={self.lp}, "
                f"peak={_sector_peak_bytes(1, self.n, self.lp, self.k):.2e}"
                f" > budget={budget:.2e})"
            )
        self.nblocks = -(-self.n // self.b)

    # -------------------------------------------------------------- panels
    def _panel_coo(self, posts, blk: int):
        """COO (linear index, value) of panel `blk` from current CSRs."""
        i0 = blk * self.b
        rows_l, cols_l, vals_l = [], [], []
        n, lp = self.n, self.lp
        for di in range(min(self.b, n - i0)):
            i = i0 + di
            for z in range(n):
                if z == i:
                    continue
                key = (i, z) if i < z else (z, i)
                s = posts.get(key)
                if s is None or s.nnz == 0:
                    continue
                coo = s.tocoo()
                if i < z:
                    r, c = coo.row, coo.col
                else:
                    r, c = coo.col, coo.row
                lin = ((di * n + z) * lp + r) * lp + c
                rows_l.append(lin.astype(np.int64))
                vals_l.append(coo.data.astype(np.float32))
        if not rows_l:
            return (np.zeros(1, np.int64), np.zeros(1, np.float32))
        return np.concatenate(rows_l), np.concatenate(vals_l)

    def _densify(self, posts, blk: int, w: np.ndarray | None):
        lin, vals = self._panel_coo(posts, blk)
        if w is not None:
            # fold w_z into the panel: entry (di, z, a, b) *= w[z]
            z = (lin // (self.lp * self.lp)) % self.n
            vals = vals * w[z].astype(np.float32)
        pad = _pow2ceil(len(lin))
        lin_p = np.zeros(pad, np.int64)
        val_p = np.zeros(pad, np.float32)
        lin_p[: len(lin)] = lin
        val_p[: len(vals)] = vals
        return _densify_fn(self.b, self.n, self.lp, pad)(
            jnp.asarray(lin_p), jnp.asarray(val_p)
        )

    # -------------------------------------------------------------- rounds
    def relax(
        self,
        posts: dict[tuple[int, int], sp.csr_matrix],
        self_coef: np.ndarray,
        z_scale: np.ndarray,
        w: np.ndarray,
        reps: int = 2,
        cutoff: float = CUTOFF,
        final_cutoff: float | None = None,
    ) -> dict[tuple[int, int], sp.csr_matrix]:
        n, b, lp, k = self.n, self.b, self.lp, self.k
        sc = np.asarray(self_coef, np.float32)
        zs = np.asarray(z_scale, np.float32)
        w = np.asarray(w, np.float32)
        uniform_w = bool(np.all(w == w[0]))
        fn = _sector_fn(b, n, lp, k)
        for it in range(reps):
            # numFilterings=-1: last round re-sparsifies at 1e-5
            # (ConsistencyStage.cpp:230-259)
            round_cutoff = (cutoff if (final_cutoff is None
                                       or it < reps - 1)
                            else final_cutoff)
            new: dict[tuple[int, int], sp.csr_matrix] = {}
            for bi in range(self.nblocks):
                panel_i = self._densify(posts, bi, None)
                for bj in range(bi, self.nblocks):
                    if bj == bi:
                        panel_j_w = (panel_i * jnp.asarray(w)[None, :,
                                                             None, None]
                                     if not uniform_w
                                     else panel_i * float(w[0]))
                    else:
                        panel_j_w = self._densify(posts, bj, w)
                    i0, j0 = bi * b, bj * b
                    # S_IJ block sits inside panel I at z-slice J
                    s_ij = jax.lax.dynamic_slice(
                        panel_i, (0, j0, 0, 0), (b, b, lp, lp)
                    ) if j0 + b <= n else jnp.pad(
                        panel_i[:, j0:, :, :],
                        ((0, 0), (0, j0 + b - n), (0, 0), (0, 0)),
                    )
                    scb = _block(sc, i0, j0, b)
                    zsb = _block(zs, i0, j0, b)
                    vals, idx = fn(
                        panel_i, panel_j_w, s_ij,
                        jnp.asarray(scb), jnp.asarray(zsb),
                        round_cutoff,
                    )
                    vals = np.asarray(vals)
                    idx = np.asarray(idx)
                    for di in range(min(b, n - i0)):
                        i = i0 + di
                        for dj in range(min(b, n - j0)):
                            j = j0 + dj
                            if j <= i or (i, j) not in posts:
                                continue
                            li, lj = self.lengths[i], self.lengths[j]
                            new[(i, j)] = _topk_to_csr(
                                vals[di, dj], idx[di, dj], li, lj
                            )
            posts = new
        return posts


def _block(m: np.ndarray, i0: int, j0: int, b: int) -> np.ndarray:
    out = np.zeros((b, b), m.dtype)
    blk = m[i0: i0 + b, j0: j0 + b]
    out[: blk.shape[0], : blk.shape[1]] = blk
    return out


def _topk_to_csr(vals: np.ndarray, idx: np.ndarray, li: int, lj: int):
    vals = vals[:li]
    idx = idx[:li]
    keep = vals > 0.0
    rows = np.repeat(np.arange(li), keep.sum(axis=1))
    cols = idx[keep]
    data = vals[keep]
    ok = cols < lj
    return sp.csr_matrix(
        (data[ok], (rows[ok], cols[ok])), shape=(li, lj)
    )


def relax_sector_device(
    posts: dict[tuple[int, int], sp.csr_matrix],
    lengths: list[int],
    reps: int = 2,
    cutoff: float = CUTOFF,
    weights: np.ndarray | None = None,
    selfweight: float = 3.0,
    selectivity: float = 200.0,
    final_cutoff: float | None = None,
) -> dict[tuple[int, int], sp.csr_matrix]:
    """Sector-tiled device relaxation with the standard coefficient
    parametrisation (see align/consistency.dense_relax_coeffs).

    weights=None -> plain baseMSA transform; else QuickProbs weighted
    accept-all.  Callers needing the stochastic z-filter must use the
    host path instead."""
    from mlprobs_tpu.align import consistency as cons

    n = len(lengths)
    sc, zs, w = cons.dense_relax_coeffs(
        n, weights, selfweight=selfweight, selectivity=selectivity
    )
    if weights is None:
        # dense_relax_coeffs' plain form assumes the tensor diagonal is
        # zero so z = i, j drop out; the panel diagonal is zero too.
        pass
    rl = SectorRelaxer(lengths)
    return rl.relax(posts, sc, zs, w, reps=reps, cutoff=cutoff,
                    final_cutoff=final_cutoff)
