#!/usr/bin/env python
"""Benchmark: end-to-end pipeline wall-clock vs the CPU reference.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Runs the FULL MLProbs pipeline (feature pass, classifiers, base MSA,
column scores, region realign, recombination) on a fixed stratified
sample of benchmark families and compares total wall-clock against the
reference pipeline's measured per-family times on this host
(BASELINE_CPU.json, reference binaries driven by
tools/measure_baseline.py).  This is the metric that matters:
`vs_baseline` is the realised speedup of the whole system, not a
kernel microbenchmark.

The device start-up (backend initialisation, paid once per process)
happens before timing starts — the same amortisation the quality
campaign uses (one worker process for the whole suite run).
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path

REF = Path("/root/reference/TEST")

# Stratified sample from BASELINE_CPU.json: small/mid/large families of
# all four suites.  The one >600 s-CPU monster (BB30003) is excluded to
# keep the bench under ~10 min; the quality campaign covers it.
FAMILIES = [
    ("sabre", "sup_387"),
    ("sabre", "sup_058"),
    ("sabre", "sup_182"),
    ("sabre", "sup_215"),
    ("ox", "12t110"),
    ("ox", "___437"),
    ("ox", "____12"),
    ("bali3", "BB11012"),
    ("bali3", "BB12026"),
    ("bali3", "BBS20026"),
    ("bali3", "BB20036"),
    ("bali3", "BB20028"),
    ("bali3", "BBS30021"),
    ("oxx", "____46"),
    ("oxx", "___121"),
    ("oxx", "_22t45"),
    ("oxx", "_12s70"),
    ("oxx", "_490t8"),
]


def main() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import mlprobs_tpu  # noqa: F401  (enables the compile cache)
    from mlprobs_tpu.core.fasta import read_fasta
    from mlprobs_tpu.pipeline.driver import run_pipeline

    # pay the device start-up before the clock starts
    np.asarray(jnp.zeros((8,)) + 1)

    base = json.load(
        open(os.path.join(os.path.dirname(__file__), "BASELINE_CPU.json"))
    )
    ref_secs = {
        (s, f["family"]): float(f["seconds"])
        for s, sd in base["suites"].items()
        for f in sd["families"]
    }

    ours_total = 0.0
    ref_total = 0.0
    per_family = {}
    for suite, fam in FAMILIES:
        records = read_fasta(REF / suite / "in" / fam)
        t0 = time.time()
        out, rep = run_pipeline(records)
        dt = time.time() - t0
        ours_total += dt
        ref_total += ref_secs[(suite, fam)]
        per_family[f"{suite}/{fam}"] = round(dt, 2)

    print(
        json.dumps(
            {
                "metric": "pipeline_sample_wall_clock",
                "value": round(ours_total, 2),
                "unit": "s (10 families)",
                "vs_baseline": round(ref_total / ours_total, 3),
            }
        )
    )


if __name__ == "__main__":
    main()
