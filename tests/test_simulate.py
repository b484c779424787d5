"""The seeded family simulator, and chip_smoke.py's refusal to run
without a GPU."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from mlprobs_tpu.bench.simulate import IDENTITY_RANGE, simulate_family

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("shape", [(64, 400, 500), (4, 121, 141)])
def test_simulator_is_deterministic_per_seed(shape):
    a = simulate_family(*shape, seed=7)
    b = simulate_family(*shape, seed=7)
    c = simulate_family(*shape, seed=8)
    assert a == b
    assert a.records != c.records
    n, lo, hi = shape
    assert len(a.records) == n
    assert all(lo <= len(s) <= hi for _, s in a.records)
    assert IDENTITY_RANGE[0] <= a.identity <= IDENTITY_RANGE[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_true_alignment_degaps_to_the_sequences(seed):
    fam = simulate_family(12, 90, 130, seed=seed)
    widths = {len(row) for _, row in fam.true_msa}
    assert len(widths) == 1
    assert [h for h, _ in fam.true_msa] == [h for h, _ in fam.records]
    for (_, row), (_, seq) in zip(fam.true_msa, fam.records):
        assert row.replace("-", "") == seq
    # no all-gap column
    cols = zip(*(row for _, row in fam.true_msa))
    assert all(any(c != "-" for c in col) for col in cols)


def _fake_smi(tmp_path: Path) -> dict:
    """An environment whose nvidia-smi answers like a card, so the run
    gets as far as JAX's own device check."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    smi = bindir / "nvidia-smi"
    smi.write_text("#!/bin/sh\necho 'Fake Card, 700.00 W'\n")
    smi.chmod(0o755)
    env = dict(os.environ)
    env["PATH"] = f"{bindir}{os.pathsep}{env.get('PATH', '')}"
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_gpu(tmp_path, alone):
    """On a CPU-only backend, and in a directory holding chip_smoke.py
    and nothing else of the repository, the script exits non-zero and
    prints no result line."""
    env = _fake_smi(tmp_path)
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        cwd = tmp_path / "alone"
        cwd.mkdir()
        script = Path(shutil.copy(script, cwd / "chip_smoke.py"))
    run = subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert run.returncode != 0
    assert '"ok"' not in run.stdout
    assert ("No module named 'mlprobs_tpu'" if alone
            else "not gpu") in run.stderr
