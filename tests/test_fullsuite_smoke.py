"""Keep scripts/perf_fullsuite.py runnable: tiny-scale CPU smoke run."""

import os
import subprocess
import sys
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_fullsuite_script_runs():
    env = dict(os.environ,
               JAX_PLATFORMS="cpu",
               PERF_SCALE="64", PERF_WARM="0")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "perf_fullsuite.py")],
        capture_output=True, text=True, timeout=420, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FULL SUITE" in out.stdout
    for stage in ("two-step correction", "ICE balancing", "compartments",
                  "TADs", "loops"):
        assert stage in out.stdout, f"missing stage {stage}\n{out.stdout}"
