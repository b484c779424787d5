"""Auxiliary pipeline utilities.

Equivalents of the reference's smaller tools:

* `annotation_scores` — per-column 0-200 reliability scores from sparse
  posteriors (the `-annot` flag; MSA.cpp:2142-2206).
* `write_clustal` — ClustalW-style .aln output (MultiSequence::WriteALN).
* `reverse_records` / `unreliable_family` — head/tail reversal and
  family-level unreliability check (preprocessing_seq_file.py /
  postprocessing_msa_file.py / detect_unreliable_family.py).
"""
from __future__ import annotations

import io

import numpy as np

from mlprobs_tpu.core.msa import MSA


def annotation_scores(alignment: MSA, posts: dict) -> np.ndarray:
    """Per-column int scores 0-200 = 200 * mean pairwise posterior.

    `posts` maps (label_i, label_j) with label_i < label_j to CSR
    posteriors over ungapped positions (0-based).
    """
    n = alignment.num_seqs
    length = alignment.length
    labels = alignment.labels
    pos = np.zeros(n, dtype=np.int64)
    out = np.zeros(length, dtype=np.int64)
    dense = {k: v.toarray() for k, v in posts.items()}
    for col in range(length):
        active = []
        for r in range(n):
            if alignment.rows[r, col] >= 0:
                active.append((int(labels[r]), int(pos[r])))
                pos[r] += 1
        if len(active) <= 1:
            continue
        active.sort()
        val = 0.0
        for a in range(len(active)):
            for b in range(a + 1, len(active)):
                la, pa = active[a]
                lb, pb = active[b]
                m = dense.get((la, lb))
                if m is not None and pa < m.shape[0] and pb < m.shape[1]:
                    val += m[pa, pb]
        out[col] = int(200 * val / (len(active) * (len(active) - 1)))
    return out


def write_clustal(alignment: MSA, width: int = 60) -> str:
    """ClustalW-flavoured .aln text (MultiSequence::WriteALN format)."""
    buf = io.StringIO()
    buf.write("MLPROBS multiple sequence alignment\n//\n\n")
    names = [h.split()[0] if h else f"seq{i}"
             for i, h in enumerate(alignment.headers)]
    pad = max(len(s) for s in names) + 4
    recs = [s for _, s in alignment.to_records()]
    for start in range(0, alignment.length, width):
        buf.write("\n")
        for i, name in enumerate(names):
            chunk = recs[i][start : start + width]
            buf.write(f"{name:<{pad}}{chunk}\n")
    return buf.getvalue()


def reverse_records(
    records: list[tuple[str, str]]
) -> list[tuple[str, str]]:
    """Reverse every sequence (preprocessing_seq_file.getTail),
    header-sorted like the reference."""
    return [(h, s[::-1]) for h, s in sorted(records)]


def unreliable_family(
    col_scores: np.ndarray, theta: float, threshold: float
) -> bool:
    """Family-level unreliability: fraction of columns with score <=
    theta reaches threshold (detect_unreliable_family.py)."""
    if len(col_scores) == 0:
        return False
    return float((np.asarray(col_scores) <= theta).mean()) >= threshold
