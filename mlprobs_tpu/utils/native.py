"""ctypes bindings to the native runtime (native/mlprobs_native.cpp).

Builds the shared library on first use (g++, a few seconds), and again
whenever the source is newer than the library, so a process never runs
a library built from another tree.  Falls back to the pure-Python
implementations if a toolchain is unavailable.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "mlprobs_native.cpp"
_LIB_PATH = Path(__file__).resolve().parents[1] / "_native.so"


def build(force: bool = False) -> Path:
    """Compile the library unless it is newer than its source."""
    if _LIB_PATH.exists() and not force:
        if not _SRC.exists() or (
            _LIB_PATH.stat().st_mtime >= _SRC.stat().st_mtime
        ):
            return _LIB_PATH
    # build beside the target and rename: a concurrent process never
    # loads a half-written library
    tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
    cmd = [
        "g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
        "-std=c++17", str(_SRC), "-o", str(tmp),
    ]
    try:
        subprocess.run(cmd, check=True)
        os.replace(tmp, _LIB_PATH)
    finally:
        tmp.unlink(missing_ok=True)
    return _LIB_PATH


@functools.lru_cache(maxsize=1)
def lib() -> ctypes.CDLL | None:
    try:
        build()
        L = ctypes.CDLL(str(_LIB_PATH))
    except (OSError, subprocess.CalledProcessError):
        return None
    i8p = ctypes.POINTER(ctypes.c_int8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    L.mwt_traceback.restype = ctypes.c_int
    L.mwt_traceback.argtypes = [i8p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, i8p]
    L.viterbi_traceback.restype = ctypes.c_int
    L.viterbi_traceback.argtypes = [i8p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, i8p]
    L.viterbi_features_batch.restype = ctypes.c_int
    L.viterbi_features_batch.argtypes = [
        i8p, i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(i8p), ctypes.POINTER(i8p), i32p, i32p,
        f64p, f64p, i32p, f64p, ctypes.c_int, f64p,
    ]
    return L


def _i8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


def mwt_traceback(dirs: np.ndarray, lx: int, ly: int) -> np.ndarray | None:
    L = lib()
    if L is None:
        return None
    dirs = np.ascontiguousarray(dirs, dtype=np.int8)
    out = np.empty(lx + ly + 2, dtype=np.int8)
    n = L.mwt_traceback(_i8(dirs), dirs.shape[1], lx, ly, _i8(out))
    return out[:n]


def viterbi_traceback(
    dirs: np.ndarray, end_state: int, lx: int, ly: int
) -> np.ndarray | None:
    L = lib()
    if L is None:
        return None
    dirs = np.ascontiguousarray(dirs, dtype=np.int8)
    out = np.empty(lx + ly + 2, dtype=np.int8)
    n = L.viterbi_traceback(
        _i8(dirs), dirs.shape[1], lx, ly, int(end_state), _i8(out)
    )
    return out[:n]


def viterbi_features_batch(
    dirs: np.ndarray,           # (B, R, C) int8
    end_states: np.ndarray,     # (B,) int32
    xs: list[np.ndarray],
    ys: list[np.ndarray],
    lxs: np.ndarray,
    lys: np.ndarray,
    blosum: np.ndarray,         # (21, 21) float64
    col_acc: np.ndarray,        # (cap,) float64, accumulated in place
):
    """Returns (pids, lengths, max_len, sp_sum, sp_cols) or None."""
    L = lib()
    if L is None:
        return None
    dirs = np.ascontiguousarray(dirs, dtype=np.int8)
    b = dirs.shape[0]
    end_states = np.ascontiguousarray(end_states, dtype=np.int32)
    lxs = np.ascontiguousarray(lxs, dtype=np.int32)
    lys = np.ascontiguousarray(lys, dtype=np.int32)
    blosum = np.ascontiguousarray(blosum, dtype=np.float64)
    xs = [np.ascontiguousarray(x, dtype=np.int8) for x in xs]
    ys = [np.ascontiguousarray(y, dtype=np.int8) for y in ys]
    xp = (ctypes.POINTER(ctypes.c_int8) * b)(*[_i8(x) for x in xs])
    yp = (ctypes.POINTER(ctypes.c_int8) * b)(*[_i8(y) for y in ys])
    pids = np.zeros(b, dtype=np.float64)
    lengths = np.zeros(b, dtype=np.int32)
    sp = np.zeros(2, dtype=np.float64)
    max_len = L.viterbi_features_batch(
        _i8(dirs),
        end_states.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        b, dirs.shape[1], dirs.shape[2],
        xp, yp,
        lxs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lys.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        blosum.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        pids.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        col_acc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(col_acc),
        sp.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return pids, lengths, max_len, float(sp[0]), float(sp[1])


_POST_MODES = {"mix": 0, "local": 1, "partition": 2, "qp": 3}


def posterior_family(
    seqs: list[np.ndarray],
    pairs: list[tuple[int, int]],
    mode: str,
    h5: dict, lo: dict, pt: dict,
    cutoff: float = 0.01,
    with_matches: bool = False,
):
    """All-pairs posteriors on the native host engine.

    Returns (csrs, scores, matches_or_None) with csrs a list of
    scipy.sparse.csr_matrix per pair, or None when the runtime is
    unavailable.  h5/lo/pt are plain numpy log-table dicts (see
    align/pairwise.native_tables)."""
    import scipy.sparse as sp

    L = lib()
    if L is None or not hasattr(L, "posterior_family_run"):
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i8p = ctypes.POINTER(ctypes.c_int8)
    L.posterior_family_run.restype = ctypes.c_int64
    L.posterior_family_run.argtypes = [
        ctypes.c_int, i8p, i64p, ctypes.c_int, i32p, ctypes.c_int,
        f32p, f32p, f32p, f32p,
        f32p, f32p, f32p, ctypes.c_float,
        f32p, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, f32p, i32p, i64p,
    ]
    L.posterior_family_export.restype = None
    L.posterior_family_export.argtypes = [i32p, i32p, f32p]

    n = len(seqs)
    seq_off = np.zeros(n + 1, np.int64)
    seq_off[1:] = np.cumsum([len(s) for s in seqs])
    seq_pool = (np.concatenate(seqs).astype(np.int8) if n
                else np.zeros(0, np.int8))
    pair_ij = np.ascontiguousarray(pairs, dtype=np.int32)
    npairs = len(pairs)
    scores = np.zeros(npairs, np.float32)
    matches = np.zeros(npairs, np.int32)
    nnz = np.zeros(npairs, np.int64)
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    h5i, h5t = f32(h5["init"]), f32(h5["trans"])
    h5m, h5n = f32(h5["lmatch"]), f32(h5["lins"])
    lot, lom = f32(lo["trans"]), f32(lo["lmatch"])
    lon = f32(lo["lins"])
    pts = f32(pt["lscore"])
    total = L.posterior_family_run(
        n, _i8(seq_pool), seq_off.ctypes.data_as(i64p),
        npairs, pair_ij.ctypes.data_as(i32p), _POST_MODES[mode],
        h5i.ctypes.data_as(f32p), h5t.ctypes.data_as(f32p),
        h5m.ctypes.data_as(f32p), h5n.ctypes.data_as(f32p),
        lot.ctypes.data_as(f32p), lom.ctypes.data_as(f32p),
        lon.ctypes.data_as(f32p), ctypes.c_float(lo["log_stay"]),
        pts.ctypes.data_as(f32p), ctypes.c_float(pt["lgap_open"]),
        ctypes.c_float(pt["lgap_ext"]),
        ctypes.c_float(cutoff),
        scores.ctypes.data_as(f32p),
        (matches.ctypes.data_as(i32p) if with_matches
         else ctypes.cast(None, i32p)),
        nnz.ctypes.data_as(i64p),
    )
    n_indptr = sum(len(seqs[i]) + 1 for i, _ in pairs)
    indptr_pool = np.zeros(n_indptr, np.int32)
    indices_pool = np.zeros(max(1, total), np.int32)
    data_pool = np.zeros(max(1, total), np.float32)
    L.posterior_family_export(
        indptr_pool.ctypes.data_as(i32p),
        indices_pool.ctypes.data_as(i32p),
        data_pool.ctypes.data_as(f32p),
    )
    csrs = []
    po = do = 0
    for k, (i, j) in enumerate(pairs):
        li, lj = len(seqs[i]), len(seqs[j])
        m = int(nnz[k])
        csrs.append(sp.csr_matrix(
            (data_pool[do:do + m].copy(),
             indices_pool[do:do + m].copy(),
             indptr_pool[po:po + li + 1].copy()),
            shape=(li, lj),
        ))
        po += li + 1
        do += m
    return csrs, scores, (matches if with_matches else None)


def viterbi_family_features(
    seqs: list[np.ndarray],
    pairs: list[tuple[int, int]],
    lo: dict,
    vinit: np.ndarray,          # (3,) float32
    blosum: np.ndarray,         # (21, 21) float64
    col_acc: np.ndarray,        # (cap,) float64, accumulated in place
):
    """Fully-native -G feature pass: Viterbi DP + traceback + stats.

    Returns (pids, path_lens, max_len, sp_sum, sp_cols) or None."""
    L = lib()
    if L is None or not hasattr(L, "viterbi_family_features"):
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i8p = ctypes.POINTER(ctypes.c_int8)
    L.viterbi_family_features.restype = ctypes.c_int
    L.viterbi_family_features.argtypes = [
        ctypes.c_int, i8p, i64p, ctypes.c_int, i32p,
        f32p, f32p, f32p, f32p, f64p,
        f64p, i32p, f64p, ctypes.c_int, f64p,
    ]
    n = len(seqs)
    seq_off = np.zeros(n + 1, np.int64)
    seq_off[1:] = np.cumsum([len(s) for s in seqs])
    seq_pool = (np.concatenate(seqs).astype(np.int8) if n
                else np.zeros(0, np.int8))
    pair_ij = np.ascontiguousarray(pairs, dtype=np.int32)
    npairs = len(pairs)
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    lot, lom, lon = f32(lo["trans"]), f32(lo["lmatch"]), f32(lo["lins"])
    vin = f32(vinit)
    bl = np.ascontiguousarray(blosum, np.float64)
    pids = np.zeros(npairs, np.float64)
    plens = np.zeros(npairs, np.int32)
    sp = np.zeros(2, np.float64)
    max_len = L.viterbi_family_features(
        n, _i8(seq_pool), seq_off.ctypes.data_as(i64p),
        npairs, pair_ij.ctypes.data_as(i32p),
        lot.ctypes.data_as(f32p), lom.ctypes.data_as(f32p),
        lon.ctypes.data_as(f32p), vin.ctypes.data_as(f32p),
        bl.ctypes.data_as(f64p),
        pids.ctypes.data_as(f64p),
        plens.ctypes.data_as(i32p),
        col_acc.ctypes.data_as(f64p), len(col_acc),
        sp.ctypes.data_as(f64p),
    )
    return pids, plens, max_len, float(sp[0]), float(sp[1])


def mwt_fill(post: np.ndarray):
    """Native MWT DP fill over a 0-based (lx, ly) posterior plane.

    Returns (dirs (lx+1, ly+1) int8, score) or None."""
    L = lib()
    if L is None or not hasattr(L, "mwt_fill_dense"):
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i8p = ctypes.POINTER(ctypes.c_int8)
    L.mwt_fill_dense.restype = ctypes.c_float
    L.mwt_fill_dense.argtypes = [f32p, ctypes.c_int, ctypes.c_int, i8p]
    post = np.ascontiguousarray(post, np.float32)
    lx, ly = post.shape
    dirs = np.empty((lx + 1, ly + 1), np.int8)
    score = L.mwt_fill_dense(
        post.ctypes.data_as(f32p), lx, ly, _i8(dirs)
    )
    return dirs, float(score)


def relax_all_pairs(
    n: int,
    lengths: np.ndarray,        # (n,) int32
    cell_ptr: np.ndarray,       # (n*n,) int64
    cell_dat: np.ndarray,       # (n*n,) int64
    indptr_pool: np.ndarray,    # int32
    indices_pool: np.ndarray,   # int32
    data_pool: np.ndarray,      # float32
    pair_ij: np.ndarray,        # (npairs, 2) int32
    self_coef: np.ndarray,      # (npairs,) float32
    z_scale: np.ndarray,        # (npairs,) float32
    w_eff: np.ndarray,          # (npairs, n) float32
    cutoff: float,
    reps: int = 1,
    cutoff_last: float | None = None,
    tperm_off: np.ndarray | None = None,   # (npairs,) int64
    tperm_pool: np.ndarray | None = None,  # int32
) -> np.ndarray | None:
    """`reps` relaxation rounds over all pairs in native code; returns
    the final output data pool (same layout as data_pool; only the
    upper pairs' regions written).  Multi-round needs tperm_off /
    tperm_pool (the upper->transpose entry mapping) so the kernel can
    refresh both orientations between rounds."""
    L = lib()
    if L is None or not hasattr(L, "relax_all_pairs"):
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    L.relax_all_pairs.restype = None
    L.relax_all_pairs.argtypes = [
        ctypes.c_int, i32p, i64p, i64p, i32p, i32p, f32p,
        ctypes.c_int64,
        ctypes.c_int, i32p, f32p, f32p, f32p,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, i64p, i32p, f32p,
    ]
    out = np.zeros_like(data_pool)
    if cutoff_last is None:
        cutoff_last = cutoff
    L.relax_all_pairs(
        n,
        lengths.ctypes.data_as(i32p),
        cell_ptr.ctypes.data_as(i64p),
        cell_dat.ctypes.data_as(i64p),
        indptr_pool.ctypes.data_as(i32p),
        indices_pool.ctypes.data_as(i32p),
        data_pool.ctypes.data_as(f32p),
        ctypes.c_int64(len(data_pool)),
        len(pair_ij),
        pair_ij.ctypes.data_as(i32p),
        self_coef.ctypes.data_as(f32p),
        z_scale.ctypes.data_as(f32p),
        w_eff.ctypes.data_as(f32p),
        ctypes.c_float(cutoff),
        ctypes.c_float(cutoff_last),
        int(reps),
        (tperm_off.ctypes.data_as(i64p) if tperm_off is not None
         else ctypes.cast(None, i64p)),
        (tperm_pool.ctypes.data_as(i32p) if tperm_pool is not None
         else ctypes.cast(None, i32p)),
        out.ctypes.data_as(f32p),
    )
    return out


def profile_posterior(
    l1: int, l2: int,
    pair_start: np.ndarray,     # (npairs,) int64
    pair_len: np.ndarray,       # (npairs,) int64
    a_idx: np.ndarray,          # (npairs,) int32
    b_idx: np.ndarray,          # (npairs,) int32
    wts: np.ndarray,            # (npairs,) float32
    coo_r: np.ndarray,          # pool int32
    coo_c: np.ndarray,          # pool int32
    coo_v: np.ndarray,          # pool float32
    maps1: np.ndarray, map1_off: np.ndarray,
    maps2: np.ndarray, map2_off: np.ndarray,
    cutoff_sub: float,
) -> np.ndarray | None:
    """Native BuildPosterior scatter (ProbabilisticModel.h:1197-1379);
    returns the dense (l1, l2) float32 plane or None when the runtime
    is unavailable."""
    L = lib()
    if L is None or not hasattr(L, "profile_posterior"):
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    L.profile_posterior.restype = None
    L.profile_posterior.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        i64p, i64p, i32p, i32p, f32p, i32p, i32p, f32p,
        i32p, i64p, i32p, i64p, ctypes.c_float, f32p,
    ]
    out = np.zeros((l1, l2), dtype=np.float32)
    L.profile_posterior(
        l1, l2, len(pair_start),
        pair_start.ctypes.data_as(i64p),
        pair_len.ctypes.data_as(i64p),
        a_idx.ctypes.data_as(i32p),
        b_idx.ctypes.data_as(i32p),
        wts.ctypes.data_as(f32p),
        coo_r.ctypes.data_as(i32p),
        coo_c.ctypes.data_as(i32p),
        coo_v.ctypes.data_as(f32p),
        maps1.ctypes.data_as(i32p),
        map1_off.ctypes.data_as(i64p),
        maps2.ctypes.data_as(i32p),
        map2_off.ctypes.data_as(i64p),
        ctypes.c_float(cutoff_sub),
        out.ctypes.data_as(f32p),
    )
    return out
