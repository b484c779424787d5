"""Family aligner: the device-engine equivalent of the reference aligners.

`align_family(..., config="pnp")` reproduces the progressive path of
baseMSA/C_P_NP_Aln (pdoAlign, MSA.cpp:895-1081): model-adaptation test,
identity-dependent posterior model mixing, UPGMA guide tree, two rounds
of consistency, weighted profile-profile progressive merge and adaptive
iterative refinement.

`config="quickprobs"` is the realignment aligner used for column blocks
(the role QuickProbs plays in the reference): same machinery with the
QuickProbs-style posterior (RMS of 5-state HMM + partition function,
PosteriorStage.cpp:123-196) and a fixed small refinement budget.
"""
from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass

import numpy as np

from mlprobs_tpu.align import consistency as cons
from mlprobs_tpu.align import pairwise, progressive
from mlprobs_tpu.align import tree as treelib
from mlprobs_tpu.align.traceback import viterbi_traceback
from mlprobs_tpu.core.msa import MSA
from mlprobs_tpu.models import params as mp
from mlprobs_tpu.utils.crand import GlibcRand
from mlprobs_tpu.utils.stats import GLOBAL as STATS


@dataclass
class FamilyStats:
    """All-pairs Viterbi statistics (ModelAdjustmentTest)."""

    avg_pid: float
    sd_pid: float
    pid_class: int
    variance_bit: int
    num_seqs: int
    # feature-pass extras (Alter_ModelAdjustmentTest)
    avg_len: int = 0
    avg_sp: float = 0.0
    peak_ratio: float = 0.0
    factor: float = 0.0


def family_viterbi_stats(
    seqs: list[np.ndarray], with_features: bool = False
) -> FamilyStats:
    """All-pairs local Viterbi PID statistics.

    With `with_features`, also aggregates the `-G` feature-pass numbers
    (MSA.cpp:646-762): mean per-column BLOSUM profile over pairwise
    alignments, average SP over all alignment columns, peak-length ratio
    (theta = 1.0) and factor = 2N - avg_alignment_len.
    """
    from mlprobs_tpu.utils import native

    n = len(seqs)
    npairs = n * (n - 1) // 2
    bl = np.asarray(mp.blosum62(), dtype=np.float64)
    pair_list = [(i, j) for i in range(n) for j in range(i + 1, n)]
    pids_all: list[np.ndarray] = []
    total_len = 0
    max_len = 0
    cap = 2 * max(len(s) for s in seqs) + 2
    col_acc = np.zeros(cap, dtype=np.float64)
    sp_sum, sp_cols = 0.0, 0.0

    # the pass runs before the family's posterior mode is known, so it
    # follows the mix-mode route
    if pairwise._native_route(seqs, "mix", pair_list):
        # fully-native -G pass: Viterbi DP + traceback + stats in
        # C++/OpenMP, no device traffic (MSA.cpp:646-762 role)
        from mlprobs_tpu.ops import viterbi as vit

        lo = pairwise.native_tables("mix", None)[1]
        res = native.viterbi_family_features(
            list(seqs), pair_list, lo,
            np.asarray(vit.VIT_INIT, np.float32), bl, col_acc,
        )
        if res is not None:
            pids, plens, max_len, sp_sum, sp_cols = res
            return _finish_family_stats(
                [pids], n, npairs, int(plens.sum()), max_len, col_acc,
                sp_sum, sp_cols, with_features,
            )

    if pairwise._engine() == "wavefront":
        # device traceback: only per-pair scalars + the per-step score
        # table cross the host boundary
        for chunk, plen, matches, scores_rev in (
            pairwise.viterbi_stat_batches(seqs, pair_list, bl)
        ):
            for k in range(len(chunk)):
                n_path = int(plen[k])
                total_len += n_path
                max_len = max(max_len, n_path)
                pids_all.append(
                    np.array([matches[k] / n_path if n_path else 0.0])
                )
                srev = scores_rev[:n_path, k]
                col_acc[:n_path] += srev[::-1]
                sp_sum += float(srev.sum())
                sp_cols += n_path
        return _finish_family_stats(
            pids_all, n, npairs, total_len, max_len, col_acc,
            sp_sum, sp_cols, with_features,
        )

    for chunk, dirs, ends in pairwise.viterbi_batches(seqs, pair_list):
        res = native.viterbi_features_batch(
            dirs, ends,
            [seqs[i] for i, _ in chunk], [seqs[j] for _, j in chunk],
            np.asarray([len(seqs[i]) for i, _ in chunk], np.int32),
            np.asarray([len(seqs[j]) for _, j in chunk], np.int32),
            bl, col_acc,
        )
        if res is not None:
            p, lens, ml, ss, sc = res
            pids_all.append(p)
            total_len += int(lens.sum())
            max_len = max(max_len, ml)
            sp_sum += ss
            sp_cols += sc
        else:  # pure-python fallback
            for k, (i, j) in enumerate(chunk):
                path = viterbi_traceback(
                    dirs[k], int(ends[k]), len(seqs[i]), len(seqs[j])
                )
                plen = len(path)
                total_len += plen
                max_len = max(max_len, plen)
                a = seqs[i][np.cumsum(path != 2) - 1]
                b = seqs[j][np.cumsum(path != 1) - 1]
                is_b = path == 0
                matches = int(((a == b) & is_b).sum())
                pids_all.append(np.array([matches / plen]))
                scores = np.where(
                    is_b & (a < 20) & (b < 20), bl[a, b], 0.0
                )
                scores = np.where(scores < 10, scores, 0.0)
                col_acc[:plen] += scores
                sp_sum += float(scores.sum())
                sp_cols += plen
    return _finish_family_stats(
        pids_all, n, npairs, total_len, max_len, col_acc,
        sp_sum, sp_cols, with_features,
    )


def _finish_family_stats(
    pids_all, n, npairs, total_len, max_len, col_acc, sp_sum, sp_cols,
    with_features,
) -> FamilyStats:
    pids = np.concatenate(pids_all)
    avg = float(pids.mean())
    sd = float(np.sqrt(((pids - avg) ** 2).mean()))
    st = FamilyStats(
        avg_pid=avg,
        sd_pid=sd,
        pid_class=mp.pid_class(avg),
        variance_bit=mp.variance_bit(sd),
        num_seqs=n,
    )
    if with_features:
        st.avg_len = total_len // npairs
        st.avg_sp = sp_sum / sp_cols if sp_cols else 0.0
        profile = col_acc[:max_len] / npairs
        st.peak_ratio = (
            float((profile >= 1.0).sum()) / max_len if max_len else 0.0
        )
        st.factor = 2.0 * n - st.avg_len
    return st


_MODE_BY_PID = {0: "mix", 1: "mix", 2: "local", 3: "partition",
                4: "partition"}


def _cons_engine() -> str:
    """Consistency engine: "device" keeps posterior planes in device
    memory and runs the relaxation as masked matmuls (the accelerator
    production path); families over the device budget, tiny families,
    or "host" fall back to the native-OpenMP / scipy CSR path.  Read
    per call so the OOM-recovery ladder can retarget a live process."""
    return os.environ.get("MLPROBS_CONSISTENCY_ENGINE", "device")


def is_oom(e: BaseException) -> bool:
    """True for XLA/PJRT device memory exhaustion (any spelling)."""
    msg = f"{type(e).__name__}: {e}"
    return ("RESOURCE_EXHAUSTED" in msg
            or "Resource exhausted" in msg
            or "out of memory" in msg.lower()
            or "Out of memory" in msg)


@contextlib.contextmanager
def host_engines():
    """Force every stage onto the host: scan/wavefront posterior engines
    placed on the CPU backend, native/scipy consistency.  The reference's
    fallback ladder re-runs a *working* binary (MLProbs.py:84-99); after
    a device OOM the device allocator may be poisoned, so the equivalent
    here is a path that never touches the accelerator."""
    import jax

    from mlprobs_tpu.align import pairwise

    old = {k: os.environ.get(k) for k in
           ("MLPROBS_POSTERIOR_ENGINE", "MLPROBS_CONSISTENCY_ENGINE")}
    os.environ["MLPROBS_POSTERIOR_ENGINE"] = (
        "native" if pairwise._native_available() else "wavefront"
    )
    os.environ["MLPROBS_CONSISTENCY_ENGINE"] = "host"
    pairwise._reset_engine_caches()
    cpu = jax.local_devices(backend="cpu")[0]
    try:
        with jax.default_device(cpu):
            yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        pairwise._reset_engine_caches()


def posterior_stage(
    seqs: list[np.ndarray], mode: str, leave_prob: float | None
) -> tuple[dict, np.ndarray]:
    """All-pairs sparse posteriors + expected-accuracy distance matrix."""
    n = len(seqs)
    posts: dict = {}
    dist = np.zeros((n, n))
    for (i, j), post_csr, score in pairwise.all_pairs_posteriors(
        seqs, mode=mode, leave_prob=leave_prob
    ):
        posts[(i, j)] = post_csr
        d = 1.0 - score / min(len(seqs[i]), len(seqs[j]))
        dist[i, j] = dist[j, i] = d
    return posts, dist



def _partition_dp_seqs(seqs: list[np.ndarray]) -> list[np.ndarray]:
    """Unknown residues for the baseMSA partition model map to matrix
    index 0 ('A'): read_matrix only initialises subst_index[0..19] to
    -1, so letters past 'T'-'A' (X, Z, U) fall through to the
    zero-initialised entry (MSAReadMatrix.cpp:91-96,
    MSAPartProbs.cpp:236-238).  Substituting at the class level keeps
    the zero-emission PAD class intact for batch padding."""
    return [np.where(s == 20, 0, s).astype(s.dtype) for s in seqs]


def align_family(
    records: list[tuple[str, str]],
    config: str = "pnp",
    stats: FamilyStats | None = None,
    strategy: int = 0,
    report: dict | None = None,
    observer=None,
    keep: dict | None = None,
) -> MSA:
    """Align one family of unaligned sequences; returns the final MSA.

    `strategy` 0 selects the progressive path; 1 selects the
    non-progressive alignment-graph path (npdoAlign, align/graph.py).
    `report`, when given, records which engines actually ran
    (posterior engine, consistency device-vs-host) — silent engine
    downgrades must be observable (SURVEY §5.5).  `observer` is the
    refinement iteration hook (IRefinementObserver /
    ExtendedMSA::iterationDone autosave role).
    """
    if report is None:
        report = {}
    msa = MSA.from_unaligned(records)
    seqs = [np.asarray(s[s >= 0]) for s in msa.rows]
    n = len(seqs)

    def note_engine(posterior_mode: str) -> None:
        # the engine that will actually run the posterior stage: small
        # families route to the native host engine
        # (pairwise._native_route)
        report["posterior_engine"] = (
            "native" if pairwise._native_route(seqs, posterior_mode)
            else pairwise._engine()
        )

    if n == 1:
        return msa
    rng = GlibcRand(1)

    if config == "pnp":
        if stats is None:
            stats = family_viterbi_stats(seqs)
        pid = stats.pid_class
        vbit = stats.variance_bit
        leave = mp.adaptive_leave_prob(stats.avg_pid)
        mode = _MODE_BY_PID[pid]
        base_reps = 100
    elif config == "quickprobs":
        pid = 0
        vbit = 1
        leave = None
        mode = "qp"
        base_reps = 30
    else:
        raise ValueError(config)

    lengths = [len(s) for s in seqs]
    if config == "pnp" and strategy == 1:
        # non-progressive path (npdoAlign): alignment graph + k-means
        # similar-set refinement; distances are similarities
        # score / #matches (MSA.cpp:1745-1752)
        from mlprobs_tpu.align.graph import graph_align
        from mlprobs_tpu.align.refine_np import np_refinement

        np_mode = {0: "mix", 1: "mix", 2: "local"}.get(pid, "partition")
        note_engine(np_mode)
        dp_seqs = (_partition_dp_seqs(seqs) if np_mode == "partition"
                   else seqs)
        posts = {}
        dist = np.zeros((n, n))
        for (i, j), csr, score, nb in pairwise.all_pairs_posteriors(
            dp_seqs, mode=np_mode, leave_prob=leave, with_matches=True
        ):
            posts[(i, j)] = csr
            s = score / nb if nb else 0.0
            dist[i, j] = dist[j, i] = s
        posts = cons.relax_sparse(posts, lengths, reps=2)
        if keep is not None:
            keep["posts"] = posts
        out = graph_align(msa, posts, seqs)
        out = np_refinement(out, posts, dist, GlibcRand(12345),
                            base_reps=100)
        return out

    if config == "quickprobs":
        # QuickProbs pipeline (ExtendedMSA.cpp:66-184 with the defaults
        # of Configuration.cpp:84-135): guide tree by kind, selectivity
        # distance preparation + normalization, saturated weights,
        # weighted relaxation with selfweight 3, weighted construction
        # with the posteriorCutoff subtraction, refinement by type.
        from mlprobs_tpu.align import refine_qp
        from mlprobs_tpu.align import tree_extra
        from mlprobs_tpu.core.config import DEFAULT as _DEF

        rcfg = _DEF.realigner
        note_engine("qp")
        tensor = None
        if _cons_engine() == "device":
            try:
                tensor = pairwise.device_posterior_tensor(
                    seqs, "qp", None, report=report
                )
            except Exception as e:
                if not is_oom(e):
                    raise
                report["consistency_downgrade"] = f"oom_tensor: {e}"[:160]
                tensor = None
        report["consistency_engine"] = (
            "device" if tensor is not None else "host"
        )
        if tensor is not None:
            posts, dist = None, tensor.dist
        else:
            posts, dist = posterior_stage(seqs, "qp", None)
        if rcfg.tree_kind == "slink":
            root = tree_extra.slink(dist)
        elif rcfg.tree_kind == "chained":
            root = tree_extra.chained(n)
        else:
            root = treelib.upgma(dist, variance_id=1)
        weights_f = cons.saturate_weights(
            treelib.qp_weights(root, n), rcfg.saturation
        )
        c_reps = (rcfg.consistency_reps
                  if n <= rcfg.large_family_threshold
                  else rcfg.consistency_reps_large)
        subd = tree_extra.subtree_distances(root, n)
        cd = cons.selectivity_distances(
            rcfg.selectivity_mode, dist, subtree=subd,
            selectivity=rcfg.selectivity,
            normalization=rcfg.selectivity_normalization,
        )
        # accept-all shortcut: the deterministic filter passes every z
        # when no combined distance can exceed the selectivity bound
        func_bound = {"max": 1.0, "min": 1.0, "sum": 2.0, "avg": 1.5}
        accept_all = (
            rcfg.selectivity_filter == "deterministic"
            and cd.max() * func_bound[rcfg.selectivity_function]
            <= rcfg.selectivity
        )
        over_budget = str(
            report.get("consistency_downgrade", "")
        ).startswith("over_budget")
        fcut = rcfg.consistency_final_cutoff

        def _host_weighted_relax(posts_csr):
            return cons.relax_sparse_weighted(
                posts_csr, lengths, weights_f, reps=c_reps,
                selfweight=rcfg.selfweight,
                selectivity=rcfg.selectivity,
                distances=None if accept_all else cd,
                final_cutoff=fcut,
            )

        if tensor is not None and accept_all:
            try:
                posts = tensor.relax_and_extract(
                    weights=weights_f, reps=c_reps,
                    selfweight=rcfg.selfweight,
                    selectivity=rcfg.selectivity,
                    final_cutoff=fcut,
                )
            except Exception as e:
                if not is_oom(e):
                    raise
                report["consistency_downgrade"] = f"oom_relax: {e}"[:160]
                report["consistency_engine"] = "host"
                posts = _host_weighted_relax(tensor.extract_csrs())
        elif accept_all and over_budget:
            # over the whole-tensor memory gate: sector-tiled device
            # relaxation (RelaxationSector.cpp role); demoted to the
            # host path if even the sector plan cannot fit, or if the
            # device still exhausts (never poison the family)
            from mlprobs_tpu.align import sector as sectorlib

            try:
                posts = sectorlib.relax_sector_device(
                    posts, lengths, reps=c_reps, weights=weights_f,
                    selfweight=rcfg.selfweight,
                    selectivity=rcfg.selectivity,
                    final_cutoff=fcut,
                )
                report["consistency_engine"] = "sector"
            except Exception as e:
                if not (is_oom(e)
                        or isinstance(e, sectorlib.SectorOverBudget)):
                    raise
                report["consistency_downgrade"] = f"oom_sector: {e}"[:160]
                report["consistency_engine"] = "host"
                posts = _host_weighted_relax(posts)
        else:
            if posts is None:
                # stochastic-filter regime: host relaxation, but the
                # posteriors come from the already-built device tensor
                posts = tensor.extract_csrs()
                report["consistency_engine"] = "host"
                report["consistency_downgrade"] = "stochastic_filter"
            posts = _host_weighted_relax(posts)
        if keep is not None:
            keep["posts"] = posts
        weights_c = cons.saturate_weights(
            treelib.qp_weights(root, n), rcfg.final_saturation
        )
        # QuickProbs construction does NOT subtract the posterior cutoff:
        # ConstructionStage::alignAlignments calls the parallel
        # buildPosterior (ParallelProbabilisticModel.cpp:301-445), which
        # plain-scatters w*v; the cutoff-subtracting base-class variants
        # (ProbabilisticModel.cpp:778-934) are dead code in this fork.
        out = progressive.process_tree(
            root, msa, posts, weights_c, cutoff_sub=0.0
        )
        iters = (rcfg.refinement_reps
                 if n <= rcfg.refinement_threshold
                 else rcfg.refinement_reps_large)
        if rcfg.refinement_type == "random":
            out = refine_qp.random_refinement(
                out, posts, weights_c, rng, iters,
                acceptance_length=rcfg.acceptance_length,
                acceptance_entropy=rcfg.acceptance_entropy,
                observer=observer,
            )
        elif rcfg.refinement_type == "tree":
            out = refine_qp.tree_refinement(
                out, posts, weights_c, rng, iters, root,
                acceptance_length=rcfg.acceptance_length,
                acceptance_entropy=rcfg.acceptance_entropy,
                observer=observer,
            )
        else:
            out = refine_qp.column_refinement(
                out, posts, weights_c, iterations=iters,
                max_depth=rcfg.max_depth,
                column_fraction=rcfg.column_fraction,
                ignore_terminal_gaps=rcfg.ignore_terminal_gaps,
                acceptance_length=rcfg.acceptance_length,
                acceptance_entropy=rcfg.acceptance_entropy,
                num_seqs_total=n,
                observer=observer,
            )
        STATS.log_device_memory("quickprobs")
        return out

    note_engine(mode)
    dp_seqs = _partition_dp_seqs(seqs) if mode == "partition" else seqs
    tensor = None
    if _cons_engine() == "device":
        try:
            tensor = pairwise.device_posterior_tensor(
                dp_seqs, mode, leave, report=report
            )
        except Exception as e:
            if not is_oom(e):
                raise
            report["consistency_downgrade"] = f"oom_tensor: {e}"[:160]
            tensor = None
    report["consistency_engine"] = (
        "device" if tensor is not None else "host"
    )
    if tensor is not None:
        dist = tensor.dist
        try:
            posts = tensor.relax_and_extract(reps=2)
        except Exception as e:
            if not is_oom(e):
                raise
            report["consistency_downgrade"] = f"oom_relax: {e}"[:160]
            report["consistency_engine"] = "host"
            posts = cons.relax_sparse(
                tensor.extract_csrs(), lengths, reps=2
            )
    else:
        posts, dist = posterior_stage(dp_seqs, mode, leave)
        if _cons_engine() == "device" and str(
            report.get("consistency_downgrade", "")
        ).startswith("over_budget"):
            # over the whole-tensor memory gate: sector-tiled device
            # relaxation keeps the plain baseMSA transform on the device
            # (RelaxationSector.cpp role); any residual device
            # exhaustion demotes to the host transform
            from mlprobs_tpu.align import sector as sectorlib

            try:
                posts = sectorlib.relax_sector_device(
                    posts, lengths, reps=2
                )
                report["consistency_engine"] = "sector"
            except Exception as e:
                if not (is_oom(e)
                        or isinstance(e, sectorlib.SectorOverBudget)):
                    raise
                report["consistency_downgrade"] = f"oom_sector: {e}"[:160]
                report["consistency_engine"] = "host"
                posts = cons.relax_sparse(posts, lengths, reps=2)
        else:
            posts = cons.relax_sparse(posts, lengths, reps=2)
    if keep is not None:
        keep["posts"] = posts
    root = treelib.upgma(dist, variance_id=vbit)
    out = progressive.compute_final_alignment(
        root, msa, posts, pid=pid, rng=rng, base_reps=base_reps
    )
    STATS.log_device_memory("pnp")
    return out


