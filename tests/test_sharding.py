"""Multi-device sharding checks.

Run in a clean subprocess with a forced 8-device CPU platform, so the
check does not depend on the device count of the test process.  The
actual assertions live in
hichap_master_tpu/testing/sharding_check.py.
"""

import os
import subprocess
import sys
import pytest


@pytest.mark.slow
def test_sharded_ops_match_single_device():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "hichap_master_tpu.testing.sharding_check"],
        env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, f"sharding check failed:\n{r.stdout}\n{r.stderr}"
    assert "OK sharded two-step matches single-device" in r.stdout
    assert "OK sharded ICE matches single-device" in r.stdout
    assert "OK analysis_train_step" in r.stdout
    assert "OK sharded sparse ICE matches single-device" in r.stdout
    assert ("OK sharded sparse genome-wide correction matches single-device"
            in r.stdout)
