"""Persistent XLA compilation cache.

Every process that runs the pipeline repays its XLA compiles unless they
persist; importing mlprobs_tpu enables the on-disk cache so compiles
amortise across processes.

Where the cache lives:

* `JAX_COMPILATION_CACHE_DIR`, when set, is used as it is: no other
  directory and no subdirectory.
* Otherwise a fixed path inside the checkout, `<repo>/.jax_cache/<tag>`
  (git-ignored), with the tag keyed per *resolved backend* (see
  backend_tag).

XLA:CPU entries are not persisted: a process whose backend is the CPU
keeps no cache.  CPU executables are AOT blobs compiled for an LLVM
target-feature string that includes pseudo-features (+prefer-no-scatter,
+prefer-no-gather, ...) derived from the detected CPU *model*, not just
its ISA flag set, and loading another host's blob flips instruction
selection (cpu_aot_loader.cc warns of SIGILL) and DP tie-breaks.  An
accelerator process still compiles a few XLA:CPU programs (host
fallback engines, CPU references); the host-CPU fingerprint goes into
every cache key it writes, so those entries never load on another host.
"""
from __future__ import annotations

import hashlib
import os
from pathlib import Path


def _cpu_fingerprint() -> str:
    """CPUID identity + ISA flags: the inputs LLVM's host detection
    uses to pick the target CPU (and with it the pseudo-feature tuning
    flags XLA bakes into AOT executables).

    The marketing "model name" alone is NOT sufficient: virtualised
    hosts report a generic string ("Intel(R) Xeon(R) Processor @
    2.10GHz") across different microarchitectures, while LLVM's
    getHostCPUName() keys on CPUID family/model/stepping — two VMs with
    identical names and flags can still get different tuning
    pseudo-features (+prefer-no-gather, ...).  Include the numeric
    CPUID identity so the cache key tracks what LLVM actually sees."""
    fields = {"model name": "", "cpu family": "", "model": "",
              "stepping": "", "vendor_id": ""}
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in fields and not fields[key]:
                    fields[key] = line.split(":", 1)[1].strip()
                elif key == "flags" and not flags:
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
    except OSError:
        pass
    ident = "|".join(fields[k] for k in sorted(fields))
    if not (ident.strip("|") or flags):
        import platform as _p

        ident = _p.processor() or _p.machine()
    return ident + "|" + flags


def backend_tag(backend) -> str:
    """Cache-dir tag for a live (initialised) JAX backend."""
    import jaxlib

    parts = [backend.platform, getattr(jaxlib, "__version__", "?")]
    # Every tag carries the host-CPU fingerprint: even an accelerator
    # process compiles XLA:CPU programs (host fallback engines), and
    # those entries land in the same cache dir — sharing it across
    # hosts with different CPUs is how wrong-machine AOT blobs travel.
    parts.append(_cpu_fingerprint())
    if backend.platform != "cpu":
        parts.append(str(getattr(backend, "platform_version", "")))
    digest = hashlib.sha256("|".join(parts).encode()).hexdigest()[:12]
    return f"{backend.platform}-{digest}"


# fixed cache root when JAX_COMPILATION_CACHE_DIR is unset
CACHE_ROOT = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir(backend, environ=os.environ) -> str | None:
    """The compile-cache directory for a live backend, or None for none
    (the CPU backend)."""
    if backend.platform == "cpu":
        return None
    env = environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return str(CACHE_ROOT / backend_tag(backend))


def enable() -> None:
    import jax
    from jax._src import cache_key, xla_bridge

    # Resolve the actual backend (initialises it): the key must reflect
    # what will execute, not the JAX_PLATFORMS env var.  A process with
    # no usable backend keeps no cache; its first JAX call reports why.
    try:
        backend = xla_bridge.get_backend()
    except RuntimeError:
        return
    path = cache_dir(backend)
    if path is None:
        # no XLA:CPU entries, not even through JAX_COMPILATION_CACHE_DIR,
        # which JAX would otherwise honour on its own
        jax.config.update("jax_enable_compilation_cache", False)
        return
    fingerprint = hashlib.sha256(_cpu_fingerprint().encode()).hexdigest()
    cache_key.custom_hook = lambda: fingerprint
    Path(path).mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

