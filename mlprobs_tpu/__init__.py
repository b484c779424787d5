"""mlprobs_tpu — an accelerator MSA engine with the capabilities of MLProbs.

A ground-up JAX/XLA re-design of the MLProbs data-centric MSA pipeline
(reference: kuangmeng/MLProbs), run on an NVIDIA H100.  The pipeline
chains:

  1. family feature extraction (all-pairs Viterbi percent identity),
  2. a strategy classifier choosing progressive / non-progressive alignment,
  3. a probabilistic-consistency base aligner (pair-HMM + partition-function
     posteriors, consistency transform, guide tree, profile-profile merges,
     iterative refinement),
  4. column reliability scoring, region segmentation classifiers,
  5. selective realignment of column blocks with a QuickProbs-style aligner,
  6. acceptance testing and recombination into the final MSA.

The O(L^2) pair dynamic programs run as batched anti-diagonal JAX scans on
the device, the O(N^3 L^3) consistency transform as one masked f32 matmul
over the dense posterior tensor; families too small to pay for the device
run the native C++/OpenMP host engines.  Host code handles trees,
traceback and orchestration.
"""

__version__ = "0.1.0"

from mlprobs_tpu.utils import jaxcache as _jaxcache

_jaxcache.enable()

from mlprobs_tpu.core.fasta import read_fasta, write_fasta  # noqa: F401
from mlprobs_tpu.core.msa import MSA  # noqa: F401
