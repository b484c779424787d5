"""Typed configuration unifying the reference's three config tiers.

Reference: MLProbs.py constants (:23-34), baseMSA's argv globals
(MSA.cpp:25-102) and QuickProbs' structured Configuration
(Configuration.h:18-127).  Defaults reproduce the shipped behaviour.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class PipelineConfig:
    """MLProbs.py tier."""

    sigma: float = 1.2         # RIR upper column-score bound
    beta: float = 0.0          # RIR lower bound
    threshold: float = 2.0     # RCR lower bound
    realign: bool = True       # run the region-realign stage


@dataclass
class AlignerConfig:
    """baseMSA tier (c_p_np_aln flags / globals)."""

    consistency_reps: int = 2          # MSA.cpp:34
    refinement_reps: int = 100         # MSA.cpp:36
    posterior_cutoff: float = 0.01     # SparseMatrix.h:14
    clustalw_output: bool = False      # -clustalw
    annotate: bool = False             # -annot
    align_order: bool = False          # -a


@dataclass
class RealignerConfig:
    """QuickProbs tier (Configuration.cpp defaults)."""

    consistency_reps: int = 2          # small families (threshold 50)
    consistency_reps_large: int = 1
    # numFilterings=-1 default: the LAST relaxation iteration skips the
    # posterior-cutoff filter and re-sparsifies at 1e-5 instead
    # (ConsistencyStage.cpp:230-259) — about half the reference's final
    # posterior entries sit below 0.01
    consistency_final_cutoff: float = 1e-5
    large_family_threshold: int = 50
    refinement_reps: int = 30          # small (RefinementBase.cpp:32-35)
    refinement_reps_large: int = 200
    refinement_threshold: int = 200
    posterior_cutoff: float = 0.01
    partition_matrix: str = "Vtml200"
    # guide tree: "upgma" | "slink" | "chained" (ExtendedMSA.cpp:86-99)
    tree_kind: str = "upgma"
    # selectivity (Configuration.cpp:105-120, ExtendedMSA.cpp:104-184)
    selectivity_mode: str = "subtree"      # subtree|similarity|seed
    selectivity_function: str = "max"      # sum|min|max|avg
    selectivity_filter: str = "deterministic"
    selectivity: float = 200.0
    selectivity_normalization: str = "no"  # no|stochastic|ranked|rankedrow
    selfweight: float = 3.0
    saturation: float = 1e-6
    final_saturation: float = 1e-6
    # refinement (Configuration.cpp:121-131)
    refinement_type: str = "column"        # column|random|tree
    column_fraction: float = 1.0
    max_depth: int = 0
    ignore_terminal_gaps: bool = True
    acceptance_length: bool = True
    acceptance_entropy: bool = False
    # refinement autosave every k iterations; 0 = off (the reference
    # default is int::max, ExtendedMSA.cpp:228-236)
    autosave_every: int = 0


@dataclass
class EngineConfig:
    """Device engine tier (no reference analogue: batching/memory plan).

    The *_budget_frac fields are fractions of the device allocator's
    limit (utils/devmem.bytes_limit)."""

    length_bucket: int = 128
    max_batch_elems: int = 2**25
    topk_per_row: int = 16
    host_mwt_area: int = 2048 * 2048
    extract_topk: int = 64            # rows pulled from device consistency
    # wavefront DP planes, planned at ~80 bytes per (pair, cell)
    wf_budget_frac: float = 0.5625
    # dense (N, N, Lp, Lp) consistency tensor; building and relaxing it
    # peaks at ~5.3x the tensor (22.6 GB for a 4.29 GB tensor, measured
    # on one H100), so the peak stays under ~85% of the limit
    cons_budget_frac: float = 0.16
    # sector-tiled relaxation (families over the dense-tensor gate):
    sector_budget_frac: float = 0.5   # two panels + output + staging
    sector_extract_topk: int = 24     # per-row entries shipped to host


@dataclass
class Config:
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    aligner: AlignerConfig = field(default_factory=AlignerConfig)
    realigner: RealignerConfig = field(default_factory=RealignerConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)


DEFAULT = Config()
