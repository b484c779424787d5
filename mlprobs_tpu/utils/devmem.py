"""Device-memory budgets, derived from the device the program runs on.

Every device-resident working set (the wavefront engine's DP planes,
the dense (N, N, Lp, Lp) consistency tensor, the sector-tiled panels)
is sized as a fraction of what the device allocator may hand out,
`memory_stats()["bytes_limit"]` (core/config.EngineConfig holds the
fractions).  The CPU backend reports no memory statistics; there the
budgets come from HOST_BYTES_LIMIT.  An accelerator that reports no
limit is an error: a guessed budget either wastes the card or runs it
out of memory mid-family.
"""
from __future__ import annotations

import functools

# Stated host figure for the CPU backend: the bytes the engines may plan
# for when the "device" is host memory.
HOST_BYTES_LIMIT = 16_000_000_000


def bytes_limit(device=None) -> int:
    """Bytes the device allocator may hand out on `device` (default:
    the first device of the default backend)."""
    if device is None:
        return _default_bytes_limit()
    if device.platform == "cpu":
        return HOST_BYTES_LIMIT
    stats = device.memory_stats() or {}
    if "bytes_limit" not in stats:
        raise RuntimeError(
            f"{device.platform} device {device.device_kind!r} reports no "
            "memory_stats()['bytes_limit']; cannot size device budgets"
        )
    return int(stats["bytes_limit"])


@functools.lru_cache(maxsize=1)
def _default_bytes_limit() -> int:
    import jax

    return bytes_limit(jax.devices()[0])


def budget(fraction: float, device=None) -> int:
    """`fraction` of the device's allocatable bytes."""
    return int(fraction * bytes_limit(device))
