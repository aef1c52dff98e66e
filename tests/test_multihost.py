"""True multi-controller SPMD validation (BASELINE config 5's N>=2 hosts):
tools/multihost.py spawns 2 separate processes x 2 local CPU devices joined
via jax.distributed (Gloo collectives standing in for the inter-host network) and runs
demod_time_parallel over the spanning mesh.  The single-process sharding
tests (test_sharding.py) cannot catch multi-controller-only failure modes
(per-process addressable shards, cross-process ppermute, global-array
construction); this one does."""

import os
import subprocess
import sys

import pytest

# multi-process subprocess meshes: the slowest coverage in the suite
# (~5 min total) — full lane only
pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "multihost.py")


def _run(nproc: int, *extra: str, timeout: float = 450) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    # pytest's timeout must exceed the launcher's global watchdog so a hang
    # takes the launcher's clean kill-and-124 path (which reaps the worker
    # process groups), not a raw TimeoutExpired that orphans the workers
    return subprocess.run(
        [sys.executable, TOOL, "--nproc", str(nproc), "--local-devices", "2",
         "--timeout", str(timeout), *extra],
        capture_output=True, text=True, timeout=timeout + 70, env=env, cwd=REPO,
    )


@pytest.mark.parametrize("layout", [(), ("--t-over-hosts",)],
                         ids=["ch-over-hosts", "t-over-hosts"])
def test_two_process_mesh(layout):
    p = _run(2, *layout)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "MULTIHOST PASS" in p.stdout, p.stdout
    # both workers reported a passing verdict
    assert p.stdout.count('"pass": true') == 2, p.stdout


@pytest.mark.parametrize("layout", [(), ("--t-over-hosts",)],
                         ids=["ch-over-hosts", "t-over-hosts"])
def test_four_process_mesh(layout):
    """4 controllers x 2 local devices (8 global), both axis layouts: the
    t-over-hosts case runs the halo ppermute across THREE process
    boundaries.  Generous watchdog: this CI box has one physical core, so
    four workers compile the program serially."""
    p = _run(4, *layout, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "MULTIHOST PASS" in p.stdout, p.stdout
    assert p.stdout.count('"pass": true') == 4, p.stdout
