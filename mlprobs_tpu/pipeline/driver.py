"""The MLProbs pipeline driver.

Device-engine equivalent of MLProbs.py: feature extraction -> classifier 1
(P/NP strategy) -> base MSA -> column scores -> classifier 3 (RCR/RIR)
-> [classifier 2 (min region length)] -> region segmentation -> selective
block realignment with acceptance -> recombination, with the reference's
stage-fallback semantics (any stage failure degrades to a whole-family
QuickProbs-role alignment, cf. MLProbs.py:84-99).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from mlprobs_tpu.align.aligner import (
    align_family, family_viterbi_stats, is_oom,
)
from mlprobs_tpu.core.msa import MSA
from mlprobs_tpu.models import forests
from mlprobs_tpu.ops.colscore import column_scores
from mlprobs_tpu.pipeline import regions as reg
from mlprobs_tpu.core.config import DEFAULT as _CFG
from mlprobs_tpu.pipeline.realign import realign_and_combine
from mlprobs_tpu.utils.stats import GLOBAL as STATS

SIGMA = _CFG.pipeline.sigma          # MLProbs.py:24
BETA = _CFG.pipeline.beta            # MLProbs.py:25
THRESHOLD = _CFG.pipeline.threshold  # MLProbs.py:26


@dataclass
class PipelineReport:
    """Stage decisions and timings for observability.

    `crash_fallback` (a stage raised; see `error` for the cause) is kept
    distinct from `whole_family_realign` (the *legitimate* RCR
    factor<=0 whole-family realign, do_realign.py ExceptionHandling) —
    the reference's killed_stage ladder conflates neither.  `fallback`
    is the union, kept for compatibility with older tooling."""

    num_seqs: int = 0
    avg_pid: float = 0.0
    sd_pid: float = 0.0
    factor: float = 0.0
    strategy: int = 0          # classifier 1: 0=P, 1=NP
    realign_mode: int = 1      # classifier 3: 0=RCR, 1=RIR
    min_length_class: int = 3  # classifier 2
    num_realign_blocks: int = 0
    fallback: bool = False
    crash_fallback: bool = False
    whole_family_realign: bool = False
    error: str = ""            # "<Type>@<stage>: <message>" on crash
    engines: dict = field(default_factory=dict)  # posterior/consistency
    final_hash: str = ""       # sha256 of the final MSA FASTA text
                               # (MultiSequence::calculateHash analogue,
                               # ExtendedMSA.cpp:221)
    timings: dict = field(default_factory=dict)


def _fallback_align(records, rep: "PipelineReport", device_suspect: bool):
    """Whole-family QuickProbs-role fallback that ALWAYS returns an MSA.

    The reference's ladder re-runs a binary that still works
    (MLProbs.py:84-99); here the accelerator's own failure mode — device
    memory exhaustion — can poison the allocator for the rest of the
    process, so an OOM (`device_suspect`) skips the accelerator and runs
    the fallback on host engines directly.  A non-OOM crash retries on
    the device first, then degrades to host if that also dies: a ladder
    that re-enters a dead device takes every later family down with it.
    The fallback counts under STATS "pipeline.fallback_host"."""
    from mlprobs_tpu.align.aligner import host_engines

    if not device_suspect:
        try:
            return align_family(
                records, config="quickprobs", report=rep.engines
            ).sort_by_header()
        except Exception as e2:  # noqa: BLE001 - ladder must not raise
            rep.error += f" | fallback: {type(e2).__name__}: {e2}"
            STATS.add("pipeline.fallback_host", 1.0)
    else:
        STATS.add("pipeline.fallback_host", 1.0)
    with host_engines():
        return align_family(
            records, config="quickprobs", report=rep.engines
        ).sort_by_header()


def run_pipeline(
    records: list[tuple[str, str]], verbose: bool = False
) -> tuple[MSA, PipelineReport]:
    """Run the full MLProbs pipeline on one family."""
    rep = PipelineReport(num_seqs=len(records))
    log = print if verbose else (lambda *a, **k: None)
    t0 = time.time()
    last = [t0]

    def mark(name):
        now = time.time()
        rep.timings[name] = now - t0
        STATS.add(f"stage.{name}", now - last[0])
        last[0] = now

    if len(records) <= 1:
        return MSA.from_records(records), rep

    seqs_only = [s for _, s in records]
    try:
        # ---- classifier-1 features (the -G pass) -----------------------
        import mlprobs_tpu.core.alphabet as alpha

        enc = [alpha.degap(alpha.encode(s)) for s in seqs_only]
        stats = family_viterbi_stats(enc, with_features=True)
        rep.avg_pid, rep.sd_pid = stats.avg_pid, stats.sd_pid
        rep.factor = stats.factor
        mark("features")
        log(f"[MAIN STEP] features: pid={stats.avg_pid:.3f} "
            f"sd={stats.sd_pid:.3f} factor={stats.factor}")

        # ---- classifier 1: strategy ------------------------------------
        strategy = forests.classify_strategy(
            stats.avg_pid, stats.num_seqs, stats.avg_len,
            stats.avg_sp, stats.peak_ratio,
        )
        rep.strategy = strategy
        mark("classifier1")
        log(f"[MAIN STEP] strategy: "
            f"{'non-progressive' if strategy else 'progressive'}")

        # ---- base MSA --------------------------------------------------
        base = align_family(
            records, config="pnp", stats=stats, strategy=strategy,
            report=rep.engines,
        )
        base = base.sort_by_header()
        mark("base_msa")

        # ---- column scores + classifier 3 ------------------------------
        col = column_scores(base.rows)
        un_sp = float(col.mean()) if col.size else 0.0
        sd_un_sp = (
            float(np.sqrt(((col - un_sp) ** 2).mean())) if col.size else 0.0
        )
        peak = float((col >= 1.0).mean()) if col.size else 0.0
        realign_mode = forests.classify_realign_strategy(
            peak, stats.avg_pid, sd_un_sp, un_sp
        )
        rep.realign_mode = realign_mode
        mark("classifier3")
        log(f"[MAIN STEP] {'RIR' if realign_mode else 'RCR'} selected")

        # ---- segmentation ----------------------------------------------
        if realign_mode == 1:
            class_lens = forests.classify_region_min_length(
                base.length, base.num_seqs, stats.avg_pid,
                stats.sd_pid, un_sp,
            )
            rep.min_length_class = int(class_lens)
            found = reg.find_unreliable_regions(
                list(col), SIGMA, BETA, class_lens
            )
        else:
            found = reg.find_reliable_regions(list(col), THRESHOLD, 0)
        blocks = reg.partition_columns(found, base.length)
        rep.num_realign_blocks = sum(b.realign for b in blocks)
        mark("segmentation")

        # ---- realign + recombine ---------------------------------------
        do_blocks = realign_mode == 1 or stats.factor > 0
        if realign_mode == 0 and stats.factor <= 0:
            # RCR with non-positive factor: realign the whole family
            # (do_realign.py ExceptionHandling) — a *legitimate* path,
            # not a crash
            out = align_family(
                records, config="quickprobs", report=rep.engines
            )
            out = out.sort_by_header()
            rep.whole_family_realign = True
            rep.fallback = True
        else:
            out = realign_and_combine(base, blocks, do_blocks)
        mark("realign")
    except Exception as e:
        if verbose:
            raise
        # stage failure: degrade to whole-family QuickProbs-role
        # alignment, recording what broke and where (SURVEY §5.5; the
        # old silent swallow hid crashes behind the fallback flag)
        stage = next(reversed(rep.timings), "start") if rep.timings \
            else "start"
        rep.error = f"{type(e).__name__}@{stage}: {e}"
        STATS.add("pipeline.crash_fallback", 1.0)
        out = _fallback_align(records, rep, device_suspect=is_oom(e))
        rep.crash_fallback = True
        rep.fallback = True
        mark("fallback")

    if out.num_seqs == 0 or out.length == 0:
        out = _fallback_align(records, rep, device_suspect=False)
        rep.crash_fallback = True
        rep.fallback = True
        rep.error = rep.error or "EmptyOutput@realign: empty final MSA"
    rep.final_hash = out.content_hash()
    mark("total")
    return out, rep
