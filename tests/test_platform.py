"""Platform decisions that hold without a GPU: engine choice, routing,
the device mesh, memory budgets, matmul precision, the native build."""
import os
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mlprobs_tpu.align import consistency as cons
from mlprobs_tpu.align import pairwise as pw
from mlprobs_tpu.utils import devmem


@pytest.fixture
def fresh_caches():
    pw._reset_engine_caches()
    yield
    pw._reset_engine_caches()


def _fake_backend(monkeypatch, platform: str, ndev: int):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    monkeypatch.setattr(jax, "devices", lambda *a: [object()] * ndev)
    import mlprobs_tpu.parallel.mesh as meshlib

    monkeypatch.setattr(meshlib, "pairs_mesh",
                        lambda n: types.SimpleNamespace(size=n))


@pytest.mark.parametrize("platform,ndev,mesh_size", [
    ("cpu", 1, None), ("cpu", 4, None), ("gpu", 1, None), ("gpu", 4, 4),
])
def test_engine_and_mesh_follow_the_backend(monkeypatch, fresh_caches,
                                            platform, ndev, mesh_size):
    """Device engines on every backend; the pairs mesh only on an
    accelerator with more than one device."""
    monkeypatch.delenv("MLPROBS_POSTERIOR_ENGINE", raising=False)
    monkeypatch.delenv("MLPROBS_MULTICHIP", raising=False)
    _fake_backend(monkeypatch, platform, ndev)
    assert pw._accelerator() == (platform != "cpu")
    assert pw._engine() == "wavefront"
    mesh = pw._mesh()
    assert (mesh.size if mesh is not None else None) == mesh_size


@pytest.mark.parametrize("mode", ["mix", "qp", "partition", "local"])
def test_native_route_follows_the_cost_model(monkeypatch, mode):
    """On the CPU backend every family takes the native engine; on a GPU
    a family runs on the device when its predicted device time (posterior
    batches x anti-diagonals, plus the dense relaxation) beats the native
    engine's (cells over cores, plus the sparse relaxation)."""
    monkeypatch.delenv("MLPROBS_NATIVE_ROUTE", raising=False)
    monkeypatch.setattr(pw, "_native_available", lambda: True)
    monkeypatch.setattr(pw, "_engine", lambda: "wavefront")
    monkeypatch.setattr(pw, "_wf_batch_size", lambda lp: 256)
    monkeypatch.setattr(os, "cpu_count", lambda: 16)

    def fam(n, length):
        return [np.zeros(length, np.int8)] * n

    sabre, main, oxx = fam(4, 131), fam(64, 480), fam(212, 139)
    monkeypatch.setattr(pw, "_accelerator", lambda: False)
    assert all(pw._native_route(f, mode) for f in (sabre, main, oxx))
    monkeypatch.setattr(pw, "_accelerator", lambda: True)
    # the three shapes behind the constants (ROADMAP 1.3)
    assert pw._native_route(sabre, mode)
    assert not pw._native_route(main, mode)
    assert pw._native_route(oxx, mode)
    monkeypatch.setenv("MLPROBS_NATIVE_ROUTE", "0")
    assert not pw._native_route(sabre, mode)


def test_route_counts_the_relaxation(monkeypatch):
    """The relaxation is part of the route: its dense device cost grows
    as N^3 Lp^3, the native one as N^3 L, so at N=212, L=139 the device
    posterior alone would win but the family still goes native."""
    monkeypatch.setattr(pw, "_wf_batch_size", lambda lp: 256)
    monkeypatch.setattr(os, "cpu_count", lambda: 16)
    oxx = [np.zeros(139, np.int8)] * 212
    pairs = [(i, j) for i in range(212) for j in range(i + 1, 212)]
    dev = pw._device_seconds(oxx, pairs, "partition")
    nat = pw._native_seconds(oxx, pairs, "partition")
    monkeypatch.setattr(pw, "_RELAX_ROUNDS", 0)
    dev_post = pw._device_seconds(oxx, pairs, "partition")
    nat_post = pw._native_seconds(oxx, pairs, "partition")
    assert dev_post < nat_post
    assert nat < dev


def test_pallas_engine_value_raises(monkeypatch, fresh_caches):
    monkeypatch.setenv("MLPROBS_POSTERIOR_ENGINE", "pallas")
    with pytest.raises(ValueError, match="pallas"):
        pw._engine()


def _device(platform, stats):
    return types.SimpleNamespace(platform=platform, device_kind="fake",
                                 memory_stats=lambda: stats)


@pytest.mark.parametrize("platform,stats,limit", [
    ("gpu", {"bytes_limit": 63_763_120_128}, 63_763_120_128),
    ("cpu", None, devmem.HOST_BYTES_LIMIT),
])
def test_budgets_follow_bytes_limit(platform, stats, limit):
    dev = _device(platform, stats)
    assert devmem.bytes_limit(dev) == limit
    assert devmem.budget(0.25, dev) == int(0.25 * limit)


def test_gpu_without_bytes_limit_raises():
    with pytest.raises(RuntimeError, match="bytes_limit"):
        devmem.bytes_limit(_device("gpu", {"bytes_in_use": 0}))


def test_wavefront_batch_follows_the_budget(monkeypatch):
    """~80 bytes per (pair, cell), rounded down to a power of two and
    capped at 256."""
    monkeypatch.setattr(pw, "_mesh", lambda: None)
    monkeypatch.setattr(pw, "_wf_plane_budget", lambda: 80 * 512 * 512 * 100)
    assert pw._wf_batch_size(512) == 64
    monkeypatch.setattr(pw, "_wf_plane_budget", lambda: 80 * 512 * 512)
    assert pw._wf_batch_size(512) == 1
    monkeypatch.setattr(pw, "_wf_plane_budget", lambda: 60 * 10**9)
    assert pw._wf_batch_size(512) == 256


def _dot_precisions(jaxpr) -> list:
    """Precision of every dot_general in a jaxpr, sub-jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                if hasattr(sub, "eqns"):            # Jaxpr
                    out.extend(_dot_precisions(sub))
                elif hasattr(sub, "jaxpr"):         # ClosedJaxpr
                    out.extend(_dot_precisions(sub.jaxpr))
    return out


def _relax_dense():
    n, lp = 3, 8
    return jax.make_jaxpr(
        lambda s, sc, zs, w: cons.relax_dense_rounds(s, sc, zs, w, reps=2)
    )(jnp.zeros((n, n, lp, lp)), jnp.zeros((n, n)), jnp.zeros((n, n)),
      jnp.zeros((n,)))


def _relax_sector():
    from mlprobs_tpu.align import sector

    b, n, lp = 2, 3, 8
    fn = sector._sector_fn(b, n, lp, 4)
    return jax.make_jaxpr(fn)(
        jnp.zeros((b, n, lp, lp)), jnp.zeros((b, n, lp, lp)),
        jnp.zeros((b, b, lp, lp)), jnp.zeros((b, b)), jnp.zeros((b, b)),
        0.01,
    )


def _relax_sharded():
    from mlprobs_tpu.parallel.mesh import pairs_mesh
    from mlprobs_tpu.parallel.sharded import make_sharded_consistency

    n, lp = 8, 8
    fn = make_sharded_consistency(pairs_mesh(8), num_seqs=n)
    return jax.make_jaxpr(fn)(
        jnp.zeros((n, n, lp, lp)), jnp.zeros((n, n)), jnp.zeros((n, n)),
        jnp.zeros((n,)),
    )


@pytest.mark.parametrize("build", [_relax_dense, _relax_sector,
                                   _relax_sharded])
def test_consistency_contractions_pinned_to_highest(build):
    """A TF32 product could move a posterior across the 0.01 / 1e-5
    cutoffs, so every consistency contraction asks for full f32."""
    precs = _dot_precisions(build().jaxpr)
    assert precs
    for p in precs:
        assert p is not None
        assert all(q == jax.lax.Precision.HIGHEST for q in p), p


def test_sharded_relax_applies_final_cutoff():
    """The mesh relaxation re-thresholds its last round at final_cutoff,
    like the single-device rounds (QuickProbs numFilterings=-1)."""
    from mlprobs_tpu.parallel.mesh import pairs_mesh

    rng = np.random.default_rng(4)
    n, lp = 6, 16
    # sparse, weak posteriors: the relaxed values straddle 0.01
    s = rng.uniform(0.01, 0.05, (n, n, lp, lp)).astype(np.float32)
    s[rng.random(s.shape) > 0.1] = 0.0
    iu = np.triu_indices(n, 1)
    s[iu[1], iu[0]] = np.swapaxes(s[iu[0], iu[1]], 1, 2)
    s[np.arange(n), np.arange(n)] = 0.0
    w = rng.random(n) + 0.5
    sc, zs, w_ = cons.dense_relax_coeffs(n, w)
    want = np.asarray(cons.relax_dense_rounds(
        jnp.asarray(s), jnp.asarray(sc), jnp.asarray(zs), jnp.asarray(w_),
        reps=2, final_cutoff=1e-5,
    ))
    got = np.asarray(pw._relax_sharded(
        jnp.asarray(s), sc, zs, w_, 2, pairs_mesh(4), final_cutoff=1e-5,
    ))
    assert ((want > 0) & (want < 0.01)).any()   # the 1e-5 round kept some
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("src_newer", [True, False])
def test_native_library_rebuilds_when_source_is_newer(
        monkeypatch, tmp_path, src_newer):
    from mlprobs_tpu.utils import native

    src = tmp_path / "lib.cpp"
    so = tmp_path / "_native.so"
    src.write_text("// source")
    so.write_text("old library")
    t_old, t_new = 1_000_000, 2_000_000
    os.utime(src, (t_new, t_new) if src_newer else (t_old, t_old))
    os.utime(so, (t_old, t_old) if src_newer else (t_new, t_new))
    calls = []

    def fake_run(cmd, check):
        calls.append(cmd)
        open(cmd[cmd.index("-o") + 1], "w").write("new library")

    monkeypatch.setattr(native, "_SRC", src)
    monkeypatch.setattr(native, "_LIB_PATH", so)
    monkeypatch.setattr(native.subprocess, "run", fake_run)
    assert native.build() == so
    assert bool(calls) == src_newer
    assert so.read_text() == ("new library" if src_newer else "old library")
    assert not list(tmp_path.glob("*.tmp"))
