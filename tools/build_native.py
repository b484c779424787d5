#!/usr/bin/env python
"""Build the native runtime shared library (g++).

    python tools/build_native.py [--force]

Loads utils/native.py by path, without importing the package (whose
import starts JAX).
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_NATIVE = (Path(__file__).resolve().parents[1]
           / "mlprobs_tpu" / "utils" / "native.py")

if __name__ == "__main__":
    spec = importlib.util.spec_from_file_location("_native_build", _NATIVE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    print(mod.build(force="--force" in sys.argv))
