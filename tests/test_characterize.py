"""Smoke test for the receiver-characterization tool (docs/CHARACTERIZATION.md)."""

import json
import os
import subprocess
import sys


def test_characterize_single_point(tmp_path):
    out_json = tmp_path / "pts.jsonl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    out = subprocess.run(
        [sys.executable, "tools/characterize.py", "--cnrs", "30",
         "--seconds", "0.75", "--json", str(out_json)],
        capture_output=True, env=env, timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert out.returncode == 0, out.stderr.decode()
    rows = [json.loads(line) for line in out_json.read_text().splitlines()]
    assert len(rows) == 1
    r = rows[0]
    # clean-ish signal: stereo pilot locked, RDS PI recovered
    assert r["cnr_db"] == 30.0
    assert r["audio_snr_db"] > 20.0
    assert r["stereo_sep_db"] > 20.0
    assert r["pi_decoded"] is True
