"""NaN-debug lane (SURVEY.md §5.2): the framework's functional purity removes
the reference's data-race class, and this lane is the committed replacement
for sanitizers — the full end-to-end chain (synth -> demod -> stereo + RDS
gates) runs with ``jax_debug_nans`` enabled, so ANY op returning NaN raises
at the producing computation instead of silently corrupting audio.

Runs in the DEFAULT test command.  For the whole suite under the flag:
``FMTPU_DEBUG_NANS=1 python -m pytest tests/``.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_e2e_chain_is_nan_free_under_debug_nans():
    """`fmtpu selftest` (the one-command e2e: modulator -> full demod chain
    -> tone/separation/RDS gates) must pass with jax_debug_nans on — it
    raises FloatingPointError inside jit the moment any stage emits NaN."""
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        JAX_DEBUG_NANS="True",
        XLA_FLAGS="--xla_force_host_platform_device_count=1",
    )
    out = subprocess.run(
        [sys.executable, "-m", "fm_radio.apps.cli", "selftest"],
        capture_output=True,
        env=env,
        timeout=900,
        cwd=REPO,
    )
    assert out.returncode == 0, out.stderr.decode()[-2000:]
    verdict = json.loads(out.stdout.decode().strip().splitlines()[-1])
    assert verdict["pass"], verdict


def test_debug_nans_lane_actually_detects():
    """Negative control: the lane must be live — a NaN-producing jitted op
    under the same flags raises FloatingPointError (guards against the flag
    silently not applying in subprocess lanes)."""
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        JAX_DEBUG_NANS="True",
    )
    code = (
        "import jax, jax.numpy as jnp\n"
        "try:\n"
        "    jax.jit(lambda x: x / x)(jnp.zeros(4)).block_until_ready()\n"
        "except FloatingPointError:\n"
        "    print('CAUGHT')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, env=env, timeout=300, cwd=REPO,
    )
    assert b"CAUGHT" in out.stdout, (out.stdout, out.stderr[-500:])
