#!/usr/bin/env python
"""Smoke run of the MLProbs pipeline on one NVIDIA GPU.

    python chip_smoke.py [--seed N]      # one card: phases a-e
    python chip_smoke.py --four-cards    # four cards: phases a and f

One process; JAX is imported once and every CPU reference runs in this
process (on the CPU device or the native library).  Any failed phase
exits non-zero without the result line.

  a. The card's name and power limit (nvidia-smi) and jax.devices();
     the platform must be "gpu" (there is no CPU fallback).
  b. Build native/mlprobs_native.cpp from this checkout: the native
     engines are the independent reference of phase e.
  c. A simulated main family (N=64, lengths 400-500, the Lp=512 bucket)
     through `cli align`: the posterior stage must run the device
     wavefront and the consistency stage the device relaxation, with no
     downgrade and no crash fallback.
  d. A sabre-median family (N=4, L~131) through the same entry point
     under the default routing.
  e. Comparisons, each printed beside its limit, on one production
     batch of sampled pairs: the posteriors `all_pairs_posteriors`
     gives on the GPU vs on the CPU device (mix and the modes the
     pipeline ran) and vs the native engine (the pipeline's modes); the
     pipeline's relaxation of each mode's device tensor vs the native
     relaxation; degapped output rows; SP against the true alignment vs
     the same family on the host engines.  Mix is not compared with the
     native engine: its local model replays the reference's approximate
     log arithmetic, ~5e-3 from the float64 oracle, where the wavefront
     is within 6e-5 of it.
  f. (--four-cards) The main family on a 4-GPU pairs mesh vs one card:
     posteriors, relaxed posteriors and the final MSA.

The last line of output is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

MAIN_SHAPE = (64, 400, 500)     # N, min length, max length
SABRE_SHAPE = (4, 121, 141)
# GPU vs CPU, the same JAX code.  XLA:CPU contracts the f32 wavefront's
# multiply-adds into FMAs where XLA:GPU rounds each product, so two runs
# of a DP over ~1000 anti-diagonals differ by f32 rounding (at L~480 the
# CPU run is itself up to 1.6e-4, relative, from the float64 oracle):
# hence the relative term.  A TF32 emission lookup (the one-hot einsum at
# default precision) exceeds this limit by 2e-4 on an H100.
POST_ATOL_CPU = 1e-5
POST_RTOL_F32 = 1e-3
POST_ATOL_NATIVE = 2e-5         # GPU vs native: the cross-engine limits
POST_RTOL_NATIVE = 1e-3         # on shared support
STRONG = 0.1                    # entries >= this: identical support
CONS_ATOL = 2e-5                # device vs native relaxation, per round
SP_MARGIN = 0.02                # SP vs the host-engine run of the family
MESH_ATOL = 1e-5                # four cards vs one (+ POST_RTOL_F32:
                                # other batch shapes, other programs)
MESH_SP_DIFF = 0.005


class PhaseFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseFailed(what)


def limit_line(name: str, value: float, limit: float) -> None:
    ok = value <= limit
    print(f"  {name}: {value:.3e} (limit {limit:.4g}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"{name} {value:.3e} over {limit:.4g}")


def kept_diff(pairs_of_planes, rtol: float):
    """Over entries both planes keep: max |a - b| and max of
    |a - b| - rtol * |b|; and the largest entry only one keeps.  Both
    planes are thresholded at the same cutoff, so a value that straddles
    it is kept by one side only, and lies within tolerance of it."""
    import numpy as np

    raw, excess, only = 0.0, 0.0, 0.0
    for a, b in pairs_of_planes:
        ka, kb = a > 0, b > 0
        both = ka & kb
        if both.any():
            d = np.abs(a[both] - b[both])
            raw = max(raw, float(d.max()))
            excess = max(excess, float((d - rtol * b[both]).max()))
        one = ka ^ kb
        if one.any():
            only = max(only, float(np.maximum(a, b)[one].max()))
    return raw, excess, only


def limit_kept(name: str, pairs_of_planes, atol: float, cutoff: float,
               rtol: float = 0.0) -> None:
    raw, excess, only = kept_diff(pairs_of_planes, rtol)
    if rtol:
        print(f"  {name} max|d| on entries both keep: {raw:.3e}",
              flush=True)
        limit_line(f"{name} max(|d| - {rtol:g}*|ref|) on entries both "
                   f"keep", excess, atol)
    else:
        limit_line(f"{name} max|d| on entries both keep", raw, atol)
    limit_line(f"{name} largest entry only one keeps (cutoff {cutoff:g})",
               only, cutoff * (1 + rtol) + atol)


class CompileMeter:
    """Seconds spent in backend compiles (persistent-cache retrievals
    included) and the persistent compile cache's hits and misses, from
    JAX's monitoring events, while the meter is entered."""

    _COMPILE = "/jax/core/compile/backend_compile_duration"
    _HIT = "/jax/compilation_cache/cache_hits"
    _MISS = "/jax/compilation_cache/cache_misses"

    def __init__(self):
        self.seconds = 0.0
        self.hits = 0
        self.misses = 0

    def _on_duration(self, event: str, secs: float, **_) -> None:
        if event == self._COMPILE:
            self.seconds += secs

    def _on_event(self, event: str, **_) -> None:
        if event == self._HIT:
            self.hits += 1
        elif event == self._MISS:
            self.misses += 1

    def __enter__(self):
        from jax import monitoring

        monitoring.register_event_duration_secs_listener(self._on_duration)
        monitoring.register_event_listener(self._on_event)
        return self

    def __exit__(self, *exc):
        from jax import monitoring

        monitoring.unregister_event_duration_listener(self._on_duration)
        monitoring.unregister_event_listener(self._on_event)
        return False


# ---------------------------------------------------------------- phases
def phase_a() -> list:
    import jax

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print("a. card (name, power limit):", flush=True)
    for line in smi.splitlines():
        print(f"  {line}", flush=True)
    devs = jax.devices()
    print(f"  jax {jax.__version__} devices {devs}", flush=True)
    check(devs[0].platform == "gpu",
          f"platform {devs[0].platform!r}, not gpu")
    return devs


def phase_b() -> None:
    from mlprobs_tpu.utils import native

    t0 = time.perf_counter()
    path = native.build(force=True)
    native.lib.cache_clear()
    check(native.lib() is not None, "native library did not load")
    print(f"b. native library {path.name} built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def align_cli(records, workdir: Path, tag: str):
    """`cli align` in-process; returns (MSA, report dict, seconds,
    compile meter)."""
    from mlprobs_tpu.core.fasta import read_fasta, write_fasta
    from mlprobs_tpu.core.msa import MSA
    from mlprobs_tpu.pipeline import cli

    src = workdir / f"{tag}.fa"
    dst = workdir / f"{tag}.msa"
    rpt = workdir / f"{tag}.json"
    write_fasta(src, records)
    with CompileMeter() as meter:
        t0 = time.perf_counter()
        rc = cli.main(["align", str(src), str(dst), "--report", str(rpt)])
        secs = time.perf_counter() - t0
    check(rc == 0, f"{tag}: cli align returned {rc}")
    return (MSA.from_records(read_fasta(dst)), json.loads(rpt.read_text()),
            secs, meter)


def check_pipeline(tag: str, records, msa, rep: dict) -> None:
    """No crash fallback, and every degapped row equals its input."""
    from mlprobs_tpu.utils.stats import GLOBAL as STATS

    check(not rep["crash_fallback"] and not rep["error"],
          f"{tag}: crash fallback ({rep['error']})")
    check(STATS.timers.get("pipeline.fallback_host", 0.0) == 0.0,
          f"{tag}: host fallback fired")
    got = {h: s.replace("-", "") for h, s in msa.to_records()}
    check(set(got) == {h for h, _ in records}, f"{tag}: headers differ")
    bad = [h for h, s in records if got[h] != s.upper()]
    check(not bad, f"{tag}: degapped rows differ from input: {bad[:3]}")
    print(f"  {tag}: {len(records)} degapped rows equal their input",
          flush=True)


def print_stage_stats(tag: str, rep: dict, secs: float, meter) -> None:
    from mlprobs_tpu.utils.stats import GLOBAL as STATS

    t = STATS.timers
    print(f"  {tag} wall {secs:.3f} s; compile {meter.seconds:.3f} s "
          f"(persistent cache hits {meter.hits}, misses {meter.misses})",
          flush=True)
    print(f"  {tag} engines {json.dumps(rep['engines'])}", flush=True)
    print(f"  {tag} timings (cumulative s) "
          f"{json.dumps(rep['timings'], default=float)}", flush=True)
    stage = {k: round(v, 6) for k, v in t.items()
             if k.startswith(("device.", "native.", "stage."))}
    print(f"  {tag} stage seconds {json.dumps(stage)}", flush=True)
    for key in sorted(k for k in t if k.startswith("device.posterior.")):
        mode = key.rsplit(".", 1)[1]
        cells = t[f"device.posterior_cells.{mode}"]
        print(f"  {tag} device posterior ({mode}, {STATS.counts[key]} "
              f"families, compiles included) {cells:.4e} cells in "
              f"{t[key]:.3f} s = {cells / t[key]:.4e} cells/s; share of "
              f"wall {t[key] / secs:.3f}", flush=True)
    mem = {k: v for k, v in STATS.values.items() if k.startswith("mem.")}
    print(f"  {tag} device memory {json.dumps(mem)}", flush=True)


def phase_c(seed: int, workdir: Path):
    from mlprobs_tpu.bench.quality import sp_tc
    from mlprobs_tpu.bench.simulate import simulate_family
    from mlprobs_tpu.core.msa import MSA
    from mlprobs_tpu.utils.stats import GLOBAL as STATS

    fam = simulate_family(*MAIN_SHAPE, seed=seed)
    lens = [len(s) for _, s in fam.records]
    print(f"c. main family N={len(lens)} lengths {min(lens)}-{max(lens)} "
          f"identity {fam.identity:.3f}", flush=True)
    STATS.reset()
    msa, rep, secs, meter = align_cli(fam.records, workdir, "main")
    print_stage_stats("main", rep, secs, meter)
    check_pipeline("main", fam.records, msa, rep)
    eng = rep["engines"]
    check(eng.get("posterior_engine") == "wavefront",
          f"main: posterior engine {eng.get('posterior_engine')!r}")
    check(eng.get("consistency_engine") == "device",
          f"main: consistency engine {eng.get('consistency_engine')!r}")
    check("consistency_downgrade" not in eng,
          f"main: downgrade {eng.get('consistency_downgrade')}")
    sp, tc = sp_tc(msa, MSA.from_records(fam.true_msa))
    print(f"  main SP {sp:.4f} TC {tc:.4f} vs the true alignment",
          flush=True)
    modes = sorted(k.rsplit(".", 1)[1] for k in STATS.timers
                   if k.startswith("device.posterior."))
    return fam, sp, modes


def phase_d(seed: int, workdir: Path) -> None:
    from mlprobs_tpu.bench.simulate import simulate_family
    from mlprobs_tpu.utils.stats import GLOBAL as STATS

    fam = simulate_family(*SABRE_SHAPE, seed=seed)
    lens = [len(s) for _, s in fam.records]
    print(f"d. sabre-median family N={len(lens)} lengths "
          f"{min(lens)}-{max(lens)}", flush=True)
    STATS.reset()
    msa, rep, secs, meter = align_cli(fam.records, workdir, "sabre")
    print_stage_stats("sabre", rep, secs, meter)
    check_pipeline("sabre", fam.records, msa, rep)


def _encoded(records):
    from mlprobs_tpu.core.alphabet import degap, encode

    return [degap(encode(s)) for _, s in records]


def _sample_pairs(n: int, k: int, seed: int):
    import numpy as np

    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    pick = np.random.default_rng(seed).choice(len(pairs), k, replace=False)
    return [pairs[p] for p in sorted(pick)]


def _mode_seqs(seqs, mode: str):
    """The sequences the pipeline's `mode` stage runs on."""
    from mlprobs_tpu.align.aligner import _partition_dp_seqs

    return _partition_dp_seqs(seqs) if mode == "partition" else seqs


def _pipeline_csrs(seqs, pairs, mode: str, device):
    """Dense planes of the CSRs `all_pairs_posteriors` yields for `pairs`
    (the pipeline's call: its tables, batch and compiled program), with
    `device` as JAX's default device, in the order of `pairs`.  The route
    is held on the device engines: a sample of pairs is no family."""
    import jax

    from mlprobs_tpu.align import pairwise as pw

    old = os.environ.get("MLPROBS_NATIVE_ROUTE")
    os.environ["MLPROBS_NATIVE_ROUTE"] = "0"
    try:
        with jax.default_device(device):
            got = {p: c.toarray() for p, c, _ in
                   pw.all_pairs_posteriors(seqs, mode, pairs=pairs)}
    finally:
        if old is None:
            os.environ.pop("MLPROBS_NATIVE_ROUTE")
        else:
            os.environ["MLPROBS_NATIVE_ROUTE"] = old
    return [got[p] for p in pairs]


def _native_excess(planes, csrs, atol: float, rtol: float):
    """max over shared entries of |d| - rtol*|native|, the shared-entry
    count, and the entries >= STRONG in one engine only whose values
    differ by more than the tolerance (not a straddle of STRONG)."""
    import numpy as np

    worst, shared, strong_bad = 0.0, 0, 0
    for g, csr in zip(planes, csrs):
        n_ = csr.toarray()
        both = (g > 0) & (n_ > 0)
        shared += int(both.sum())
        excess = np.abs(g[both] - n_[both]) - rtol * np.abs(n_[both])
        if excess.size:
            worst = max(worst, float(excess.max()))
        moved = (g >= STRONG) != (n_ >= STRONG)
        far = np.abs(g - n_) > atol + rtol * np.maximum(g, n_)
        strong_bad += int((moved & far).sum())
    return worst, shared, strong_bad


def compare_posteriors(seqs, pairs, mode: str, vs_native: bool) -> None:
    """GPU vs CPU for the same JAX code, and GPU vs the native engine."""
    import jax

    from mlprobs_tpu.align import pairwise as pw
    from mlprobs_tpu.utils import native

    seqs = _mode_seqs(seqs, mode)
    gpu = _pipeline_csrs(seqs, pairs, mode, jax.devices()[0])
    cpu = _pipeline_csrs(seqs, pairs, mode, jax.devices("cpu")[0])
    limit_kept(f"posterior {mode} GPU vs CPU", zip(gpu, cpu),
               POST_ATOL_CPU, pw.CUTOFF, rtol=POST_RTOL_F32)
    if not vs_native:
        return
    out = native.posterior_family(
        list(seqs), list(pairs), mode, *pw.native_tables(mode, None),
        cutoff=pw.CUTOFF,
    )
    check(out is not None, "native posterior engine unavailable")
    worst, shared, strong_bad = _native_excess(
        gpu, out[0], POST_ATOL_NATIVE, POST_RTOL_NATIVE)
    limit_line(f"posterior {mode} GPU vs native max(|d| - "
               f"{POST_RTOL_NATIVE:g}*|native|) over {shared} shared "
               f"entries", worst, POST_ATOL_NATIVE)
    print(f"  posterior {mode} entries >= {STRONG} in one engine only, "
          f"beyond the tolerance: {strong_bad} (limit 0) "
          f"{'ok' if not strong_bad else 'FAIL'}", flush=True)
    check(strong_bad == 0, f"posterior {mode}: strong support differs")


def _relax_schedule(mode: str, tensor):
    """(weights, selfweight, rounds, final cutoff) of the pipeline's
    relaxation of a `mode` tensor (align/aligner.align_family): the
    realigner's weighted rounds for "qp", else the base stage's two
    plain rounds."""
    from mlprobs_tpu.align import consistency as cons
    from mlprobs_tpu.align import tree as treelib
    from mlprobs_tpu.core.config import DEFAULT

    if mode != "qp":
        return None, 3.0, 2, None
    rcfg = DEFAULT.realigner
    n = tensor.S.shape[0]
    root = treelib.upgma(tensor.dist, variance_id=1)
    weights = cons.saturate_weights(treelib.qp_weights(root, n),
                                    rcfg.saturation)
    reps = (rcfg.consistency_reps if n <= rcfg.large_family_threshold
            else rcfg.consistency_reps_large)
    return weights, rcfg.selfweight, reps, rcfg.consistency_final_cutoff


def compare_consistency(seqs, mode: str) -> None:
    """Each round of the pipeline's relaxation of the `mode` device
    tensor, device vs native, from the same input: the unrelaxed
    posteriors, then the device's output of the round before.  (Over
    chained rounds an entry that straddles the 0.01 cutoff after one
    round is kept by one engine only and moves its neighbours in the
    next by up to ~0.01/N, so the rounds are compared one at a time.)"""
    import jax.numpy as jnp
    import numpy as np

    from mlprobs_tpu.align import consistency as cons
    from mlprobs_tpu.align import pairwise as pw

    seqs = _mode_seqs(seqs, mode)
    report: dict = {}
    tensor = pw.device_posterior_tensor(seqs, mode, None, report=report)
    check(tensor is not None, f"no {mode} device tensor: {report}")
    lens = [len(s) for s in seqs]
    weights, selfweight, reps, final = _relax_schedule(mode, tensor)
    sc, zs, w = (jnp.asarray(a) for a in cons.dense_relax_coeffs(
        len(seqs), weights, selfweight=selfweight))
    for rnd in range(1, reps + 1):
        cut = final if rnd == reps else None
        posts_in = tensor.extract_csrs()
        row_max = max(int(np.diff(c.indptr).max())
                      for c in posts_in.values())
        print(f"  {mode} round {rnd} input rows hold at most {row_max} "
              f"entries (extraction keeps {pw.EXTRACT_TOPK}: lossless "
              f"when below)", flush=True)
        check(row_max < pw.EXTRACT_TOPK, "device extraction truncated")
        got = tensor.relax_and_extract(weights=weights, reps=1,
                                       selfweight=selfweight,
                                       final_cutoff=cut)
        want = cons.relax_native(posts_in, lens, reps=1, weights=weights,
                                 selfweight=selfweight, final_cutoff=cut)
        check(want is not None, "native relaxation unavailable")
        limit_kept(f"consistency {mode} round {rnd} of {reps} device vs "
                   f"native", ((got[k].toarray(), v.toarray())
                               for k, v in want.items()),
                   CONS_ATOL, cut if cut is not None else cons.CUTOFF)
        tensor = pw.DevicePosteriorTensor(
            cons.relax_dense_rounds(tensor.S, sc, zs, w, reps=1),
            tensor.pairs, tensor.dist, lens,
        )


def phase_e(fam, sp_device: float, modes: list, seed: int,
            workdir: Path) -> None:
    from mlprobs_tpu.align.aligner import host_engines
    from mlprobs_tpu.bench.quality import sp_tc
    from mlprobs_tpu.core.msa import MSA
    from mlprobs_tpu.utils.stats import GLOBAL as STATS

    from mlprobs_tpu.align import pairwise as pw

    seqs = _encoded(fam.records)
    lp = pw._bucket_len(max(len(s) for s in seqs))
    pairs = _sample_pairs(len(seqs), pw._wf_batch_size(lp), seed)
    print(f"e. comparisons: {len(pairs)} sampled pairs (one batch at "
          f"Lp={lp}); the pipeline ran modes {modes}", flush=True)
    compare_posteriors(seqs, pairs, "mix", vs_native=False)
    for mode in modes:
        compare_posteriors(seqs, pairs, mode, vs_native=True)
    for mode in modes:
        compare_consistency(seqs, mode)
    STATS.reset()
    with host_engines():
        msa, rep, secs, _ = align_cli(fam.records, workdir, "main_host")
    check(not rep["crash_fallback"], f"host run crashed: {rep['error']}")
    sp_host, _ = sp_tc(msa, MSA.from_records(fam.true_msa))
    print(f"  main family on host engines: {secs:.3f} s, SP {sp_host:.4f}",
          flush=True)
    limit_line(f"SP shortfall vs host engines (device SP {sp_device:.4f})",
               sp_host - sp_device, SP_MARGIN)


def _use_mesh(setting: str):
    """Switch the pairs mesh on ("auto") or off ("0"); returns a tag."""
    from mlprobs_tpu.align import pairwise as pw

    os.environ["MLPROBS_MULTICHIP"] = setting
    pw._reset_engine_caches()
    mesh = pw._mesh()
    check((mesh is None) == (setting == "0"), f"mesh {mesh} for {setting}")
    return "one" if mesh is None else f"mesh{mesh.size}"


def phase_f(seed: int, workdir: Path) -> None:
    """Main family on the 4-card pairs mesh vs device 0 alone: the
    posteriors, each relaxation round from the same input (as in phase
    e), and the pipeline's final MSA."""
    import jax.numpy as jnp

    from mlprobs_tpu.align import consistency as cons
    from mlprobs_tpu.align import pairwise as pw
    from mlprobs_tpu.bench.quality import sp_tc
    from mlprobs_tpu.bench.simulate import simulate_family
    from mlprobs_tpu.core.msa import MSA

    fam = simulate_family(*MAIN_SHAPE, seed=seed)
    seqs = _encoded(fam.records)
    lens = [len(s) for s in seqs]
    print(f"f. main family N={len(seqs)} on one card and on the "
          f"4-card pairs mesh", flush=True)
    tensors, posts = {}, {}
    for setting in ("0", "auto"):
        tag = _use_mesh(setting)
        t0 = time.perf_counter()
        tensors[tag] = pw.device_posterior_tensor(seqs, "mix", None)
        check(tensors[tag] is not None, f"{tag}: no device tensor")
        posts[tag] = tensors[tag].extract_csrs()
        print(f"  {tag}: posterior tensor {time.perf_counter() - t0:.3f} s "
              f"(compiles included)", flush=True)
    (p1, p4) = posts.values()
    limit_kept("posteriors mesh vs one card",
               ((p1[k].toarray(), p4[k].toarray()) for k in p1),
               MESH_ATOL, pw.CUTOFF, rtol=POST_RTOL_F32)
    sc, zs, w = (jnp.asarray(a) for a in cons.dense_relax_coeffs(len(seqs)))
    base = tensors["one"]
    for rnd in (1, 2):
        relaxed = {}
        for setting in ("0", "auto"):
            tag = _use_mesh(setting)
            t0 = time.perf_counter()
            relaxed[tag] = pw.DevicePosteriorTensor(
                base.S, base.pairs, base.dist, lens
            ).relax_and_extract(reps=1)
            print(f"  {tag}: relaxation round {rnd} "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
        r1, r4 = relaxed.values()
        limit_kept(f"relaxation round {rnd} mesh vs one card",
                   ((r1[k].toarray(), r4[k].toarray()) for k in r1),
                   MESH_ATOL, pw.CUTOFF, rtol=POST_RTOL_F32)
        base = pw.DevicePosteriorTensor(
            cons.relax_dense_rounds(base.S, sc, zs, w, reps=1),
            base.pairs, base.dist, lens,
        )
    del tensors, base
    finals = {}
    for setting in ("0", "auto"):
        tag = _use_mesh(setting)
        msa, rep, secs, _ = align_cli(fam.records, workdir, tag)
        check(not rep["crash_fallback"], f"{tag}: {rep['error']}")
        sp, _ = sp_tc(msa, MSA.from_records(fam.true_msa))
        print(f"  {tag}: pipeline {secs:.3f} s (compiles included), SP "
              f"{sp:.4f}, engines {json.dumps(rep['engines'])}", flush=True)
        finals[tag] = (rep["final_hash"], sp)
    os.environ.pop("MLPROBS_MULTICHIP", None)
    pw._reset_engine_caches()
    (h1, sp1), (h4, sp4) = finals.values()
    if h1 == h4:
        print("  final MSA hash identical on the mesh and on one card",
              flush=True)
    else:
        print("  final MSA hashes differ: last-bit differences between the "
              "sharded and single-card programs move a cutoff or a "
              "tie-break", flush=True)
        limit_line("final SP |mesh - one card|", abs(sp4 - sp1),
                   MESH_SP_DIFF)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU mesh phase (f)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    import mlprobs_tpu  # noqa: F401  (fails outside a checkout)

    devs = phase_a()
    with tempfile.TemporaryDirectory() as td:
        workdir = Path(td)
        if args.four_cards:
            check(len(devs) == 4, f"--four-cards needs 4 GPUs, "
                                  f"found {len(devs)}")
            phase_f(args.seed, workdir)
        else:
            phase_b()
            fam, sp, modes = phase_c(args.seed, workdir)
            phase_d(args.seed, workdir)
            phase_e(fam, sp, modes, args.seed, workdir)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
