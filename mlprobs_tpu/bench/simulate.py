"""Seeded protein-family simulator with a known true alignment.

A family evolves down a random tree from one root sequence:

* the tree is a coalescent (random pairwise merges) scaled to a fixed
  root-to-leaf height, so the mean pairwise identity depends on the
  height rather than on the number of sequences;
* root residues are drawn from the pair-HMM's single-residue emission
  distribution (hmm5 insert emissions, models/params.py `lins`);
* along each branch of length t, each residue is substituted with
  probability 1 - exp(-t), the new residue drawn from the hmm5 match
  emissions conditioned on the old one, and insertions and deletions
  start at `indel_rate` per residue per unit length, with geometric
  lengths.

Every residue carries a homology key, so the leaves' true alignment
follows from the keys: residues with equal keys share a column.  Keys
are tuples; an insertion after key K gets keys K + (-event, i), which
sort after K and before anything inserted after K earlier, so one sort
of all keys orders the columns of every leaf at once.

numpy only; nothing is downloaded.  The same seed gives the same family.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from mlprobs_tpu.core.alphabet import AMINO_ORDER
from mlprobs_tpu.models import params as mp

# root-to-leaf height: a mean pairwise identity of ~30-55% in the true
# alignment; draws outside IDENTITY_RANGE are redrawn
DEFAULT_HEIGHT = 2.0
IDENTITY_RANGE = (0.25, 0.60)
DEFAULT_INDEL_RATE = 0.02
MEAN_INDEL_LEN = 2.5


@dataclass
class SimFamily:
    records: list[tuple[str, str]]    # unaligned (header, residues)
    true_msa: list[tuple[str, str]]   # the same rows, aligned ('-' gaps)
    identity: float                   # mean pairwise identity, true MSA


def _tables() -> tuple[np.ndarray, np.ndarray]:
    """(background (20,), substitution P(b | a) (20, 20))."""
    p = mp.hmm5_params()
    bg = np.exp(p.lins[:20, 0].astype(np.float64))
    bg /= bg.sum()
    sub = np.exp(p.lmatch[:20, :20].astype(np.float64))
    sub /= sub.sum(axis=1, keepdims=True)
    return bg, sub


def _coalescent(n: int, rng: np.random.Generator, height: float):
    """Parent index and branch length per node; leaves are 0..n-1 and
    the root is the last node."""
    parent = [-1] * (2 * n - 1)
    node_h = [0.0] * (2 * n - 1)
    live = list(range(n))
    t = 0.0
    nxt = n
    while len(live) > 1:
        k = len(live)
        t += rng.exponential(2.0 / (k * (k - 1)))
        a, b = rng.choice(k, size=2, replace=False)
        ca, cb = live[a], live[b]
        parent[ca] = parent[cb] = nxt
        node_h[nxt] = t
        live = [x for i, x in enumerate(live) if i not in (a, b)] + [nxt]
        nxt += 1
    scale = height / t if t > 0 else 0.0
    blen = [
        (node_h[parent[v]] - node_h[v]) * scale if parent[v] >= 0 else 0.0
        for v in range(2 * n - 1)
    ]
    return parent, blen


def _evolve(res, keys, t, rng, sub, bg, indel_rate, counter):
    """One branch: substitutions, then deletions and insertions."""
    res = res.copy()
    hit = rng.random(len(res)) < 1.0 - np.exp(-t)
    for i in np.flatnonzero(hit):
        res[i] = rng.choice(20, p=sub[res[i]])
    res, keys = list(res), list(keys)
    n_del = rng.poisson(indel_rate * t * len(res))
    for _ in range(n_del):
        if len(res) < 2:
            break
        ln = min(rng.geometric(1.0 / MEAN_INDEL_LEN), len(res) - 1)
        at = int(rng.integers(0, len(res) - ln + 1))
        del res[at:at + ln], keys[at:at + ln]
    n_ins = rng.poisson(indel_rate * t * len(res))
    for _ in range(n_ins):
        ln = rng.geometric(1.0 / MEAN_INDEL_LEN)
        at = int(rng.integers(0, len(res) + 1))   # insert before `at`
        anchor = keys[at - 1] if at > 0 else ()
        counter[0] += 1
        new_keys = [anchor + (-counter[0], i) for i in range(ln)]
        new_res = list(rng.choice(20, size=ln, p=bg))
        res[at:at] = new_res
        keys[at:at] = new_keys
    return np.asarray(res, np.int8), keys


def _mean_identity(rows: np.ndarray) -> float:
    """Mean over sequence pairs of identical / aligned residue pairs."""
    n = rows.shape[0]
    ids = []
    for i in range(n):
        both = (rows[i] >= 0) & (rows[i + 1:] >= 0)
        same = both & (rows[i] == rows[i + 1:])
        cnt = both.sum(axis=1)
        ids.extend((same.sum(axis=1) / np.maximum(cnt, 1)).tolist())
    return float(np.mean(ids)) if ids else 1.0


def simulate_family(
    num_seqs: int,
    min_len: int,
    max_len: int,
    seed: int,
    height: float = DEFAULT_HEIGHT,
    indel_rate: float = DEFAULT_INDEL_RATE,
    max_tries: int = 100,
) -> SimFamily:
    """Simulate a family of `num_seqs` sequences whose lengths all lie in
    [min_len, max_len] and whose mean pairwise identity lies in
    IDENTITY_RANGE.  A draw outside either range is redrawn from the same
    stream, so the result depends on the arguments alone."""
    if not 0 < min_len <= max_len:
        raise ValueError((min_len, max_len))
    rng = np.random.default_rng(seed)
    bg, sub = _tables()
    root_len = (min_len + max_len) // 2
    for _ in range(max_tries):
        parent, blen = _coalescent(num_seqs, rng, height)
        root = len(parent) - 1
        children: dict[int, list[int]] = {}
        for v, p in enumerate(parent):
            if p >= 0:
                children.setdefault(p, []).append(v)
        seqs = {root: (rng.choice(20, size=root_len, p=bg).astype(np.int8),
                       [(k,) for k in range(root_len)])}
        counter = [0]
        stack = [root]
        while stack:
            v = stack.pop()
            for c in children.get(v, []):
                seqs[c] = _evolve(*seqs[v], blen[c], rng, sub, bg,
                                  indel_rate, counter)
                stack.append(c)
        leaves = [seqs[i] for i in range(num_seqs)]
        if not all(min_len <= len(r) <= max_len for r, _ in leaves):
            continue
        cols = {k: c for c, k in enumerate(sorted({k for _, ks in leaves
                                                   for k in ks}))}
        rows = np.full((num_seqs, len(cols)), -1, np.int8)
        for i, (r, ks) in enumerate(leaves):
            rows[i, [cols[k] for k in ks]] = r
        identity = _mean_identity(rows)
        if IDENTITY_RANGE[0] <= identity <= IDENTITY_RANGE[1]:
            break
    else:
        raise RuntimeError(
            f"no draw with lengths in [{min_len}, {max_len}] and identity "
            f"in {IDENTITY_RANGE} in {max_tries} tries"
        )
    alpha = np.frombuffer(AMINO_ORDER.encode(), np.uint8)
    names = [f"sim{seed}_{i:03d}" for i in range(num_seqs)]
    records = [(h, alpha[r].tobytes().decode())
               for h, (r, _) in zip(names, leaves)]
    true_msa = [
        (h, np.where(row >= 0, alpha[np.maximum(row, 0)],
                     ord("-")).astype(np.uint8).tobytes().decode())
        for h, row in zip(names, rows)
    ]
    return SimFamily(records, true_msa, identity)
