"""chip_smoke.py refuses to report a result without a GPU."""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _printed_result(stdout):
    for line in stdout.splitlines():
        try:
            if "ok" in json.loads(line):
                return True
        except ValueError:
            pass
    return False


def test_chip_smoke_refuses_cpu_backend():
    p = _run(REPO, "chip_smoke.py")
    assert p.returncode != 0
    assert "no GPU" in p.stdout
    assert not _printed_result(p.stdout)


def test_chip_smoke_alone_prints_no_result(tmp_path):
    """Copied away from the repository it has nothing to run."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _run(tmp_path, "chip_smoke.py")
    assert p.returncode != 0
    assert not _printed_result(p.stdout)
