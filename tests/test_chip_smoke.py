"""chip_smoke.py: the CPU rehearsal runs every phase, and without a GPU the
real run refuses to report a result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _run(args, cwd=REPO, timeout=120):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_rehearsal_runs_every_phase():
    r = _run([SCRIPT, "--rehearse"])
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout.splitlines()
    for k in range(1, 5):
        assert any(ln.startswith(f"== phase {k}:") for ln in out), k
    parity = [ln for ln in out if ln.startswith("parity ")]
    assert len(parity) == 8 and all(ln.endswith("PASS") for ln in parity)
    assert any(ln.startswith("loops phase escalate:") for ln in out)
    assert any("compaction overflows" in ln for ln in out)
    last = json.loads(out[-1])
    assert last["ok"] is True and set(last) == {"ok", "device"}
    assert last["device"]["platform"] == "cpu"
    assert set(last["device"]) == {"platform", "kind", "count"}


def test_without_gpu_exits_nonzero():
    r = _run([SCRIPT], timeout=60)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(SCRIPT, tmp_path)
    r = _run([str(tmp_path / "chip_smoke.py"), "--rehearse"], cwd=tmp_path,
             timeout=60)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_parity_phase_on_gpu():
    """The parity phase at rehearsal widths, on the card."""
    sys.path.insert(0, REPO)
    import chip_smoke

    smoke = chip_smoke.Smoke(rehearse=True, seed=0)
    smoke.phase_parity()
    assert smoke.failures == []
