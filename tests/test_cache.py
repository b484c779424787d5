"""XLA compilation-cache placement and keying (utils/jaxcache).

Placement: JAX_COMPILATION_CACHE_DIR as it is when set, else a fixed
path in the checkout; no persistent cache on the CPU backend.

Cross-host safety: CPU AOT executables embed model-derived LLVM
pseudo-features, so two backends that differ in *any* fingerprint input
(platform, jaxlib version, CPU model, ISA flags, PJRT platform_version)
must map to different cache directories.
"""
import types
from pathlib import Path

from mlprobs_tpu.utils import jaxcache


def _fake_backend(platform, version=""):
    return types.SimpleNamespace(
        platform=platform, platform_version=version
    )


def test_distinct_platform_versions_get_distinct_dirs():
    a = jaxcache.backend_tag(_fake_backend("gpu", "PJRT C API v1"))
    b = jaxcache.backend_tag(_fake_backend("gpu", "PJRT C API v2"))
    assert a != b
    assert a.startswith("gpu-") and b.startswith("gpu-")


def test_cpu_fingerprint_drives_key(monkeypatch):
    calls = iter(["Model-A|flags", "Model-B|flags"])
    monkeypatch.setattr(
        jaxcache, "_cpu_fingerprint", lambda: next(calls)
    )
    a = jaxcache.backend_tag(_fake_backend("cpu"))
    b = jaxcache.backend_tag(_fake_backend("cpu"))
    assert a != b


def test_cpu_key_ignores_env_platform(monkeypatch):
    """The tag comes from the resolved backend object, never from
    JAX_PLATFORMS (the old bug: resolved-backend runs went unkeyed)."""
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    tag = jaxcache.backend_tag(_fake_backend("cpu"))
    assert tag.startswith("cpu-")


def test_live_backend_tag_is_stable():
    from jax._src import xla_bridge

    b = xla_bridge.get_backend()
    assert jaxcache.backend_tag(b) == jaxcache.backend_tag(b)


def test_cpu_fingerprint_includes_cpuid_identity():
    """Virtualised hosts report a generic marketing name across
    different microarchitectures; LLVM keys its tuning pseudo-features
    (+prefer-no-gather, ...) on CPUID family/model/stepping.  The
    fingerprint must carry the numeric identity, not just the name."""
    fp = jaxcache._cpu_fingerprint()
    try:
        fields = {}
        with open("/proc/cpuinfo") as f:
            for line in f:
                k = line.split(":", 1)[0].strip()
                if k in ("cpu family", "model", "stepping") \
                        and k not in fields:
                    fields[k] = line.split(":", 1)[1].strip()
    except OSError:
        return  # non-Linux host: nothing to assert
    for k, v in fields.items():
        assert v in fp.split("|"), f"{k}={v} missing from fingerprint"


def test_cache_dir_is_the_env_dir_as_it_is(tmp_path):
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "given")}
    got = jaxcache.cache_dir(_fake_backend("gpu", "v1"), env)
    assert got == str(tmp_path / "given")


def test_cache_dir_defaults_to_a_fixed_path_in_the_checkout():
    backend = _fake_backend("gpu", "v1")
    got = jaxcache.cache_dir(backend, {})
    root = Path(__file__).resolve().parents[1] / ".jax_cache"
    assert got == str(root / jaxcache.backend_tag(backend))
    assert got == jaxcache.cache_dir(backend, {})   # no pid, no time


def test_cpu_backend_persists_nothing(tmp_path):
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    assert jaxcache.cache_dir(_fake_backend("cpu"), env) is None
    assert jaxcache.cache_dir(_fake_backend("cpu"), {}) is None


def test_enable_on_the_cpu_backend_turns_the_cache_off(monkeypatch,
                                                      tmp_path):
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_enable_compilation_cache
    try:
        jaxcache.enable()
        assert not jax.config.jax_enable_compilation_cache
    finally:
        jax.config.update("jax_enable_compilation_cache", before)
    assert not any(tmp_path.iterdir())
