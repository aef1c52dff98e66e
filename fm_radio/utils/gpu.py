"""The card a measurement ran on: device identity, power limit, and the
reduction of a profiler trace to per-stage device time.

Every number the benchmark and the smoke check print names its device
(``jax.devices()[0].platform``, ``device_kind`` and the device count) and
the card's power limit, because a card set below its maximum runs slower
under load.  A measurement path that finds no GPU fails; it does not fall
back to the CPU.
"""

from __future__ import annotations

import glob
import os
import re
import subprocess

# named_scope names of models/demod.py and models/wideband.py, in chain order
STAGES = ("channelizer", "front_end", "mid_end", "pilot_pll", "extract",
          "rds_sync")


def card_line() -> str:
    """``name, power.limit`` of the card(s) as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def device_info() -> dict:
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """Device info of a GPU backend; SystemExit(2) on any other backend."""
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default backend is {info['platform']!r} "
            f"({info['kind']}); this measurement runs only on the card")
    return info


def _hlo_scopes(hlo_text: str) -> dict[str, str]:
    """Optimised-HLO instruction name -> the stage its op_name metadata
    sits under (fusions inherit the metadata of their root)."""
    scopes = {}
    pat = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*op_name=\"([^\"]*)\"")
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if not m:
            continue
        for stage in STAGES:
            if f"/{stage}/" in m.group(2) or m.group(2).endswith(f"/{stage}"):
                # kernels are named after their HLO op with "." -> "_"
                scopes[m.group(1)] = scopes[m.group(1).replace(".", "_")] = stage
    return scopes


def stage_device_times(trace_dir: str, hlo_text: str = "") -> dict:
    """Reduce the newest ``jax.profiler`` trace under ``trace_dir``.

    Returns per-stage kernel time (ms, summed over GPU stream events that
    fall under each ``named_scope`` stage, else "other"), the window
    (first kernel start to last kernel end), the busy time (union of the
    kernel intervals) and the idle share (1 - busy / window).  A kernel is
    attributed through its stats text (XLA records the op's scope there)
    or, failing that, through ``hlo_text``: the optimised HLO of the traced
    program, whose op_name metadata names the scope of each instruction.
    """
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    pd = ProfileData.from_file(max(paths, key=os.path.getmtime))
    by_hlo = _hlo_scopes(hlo_text)
    times = {s: 0.0 for s in (*STAGES, "other")}
    spans = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.lower().startswith("stream"):
                continue  # derived "XLA Ops"/"XLA Modules" lines repeat them
            for ev in line.events:
                text = ev.name + " " + " ".join(str(st) for st in ev.stats)
                stage = next((s for s in STAGES if f"/{s}/" in text), None)
                if stage is None:
                    stage = next((by_hlo[t] for t in re.findall(
                        r"[\w.\-]+", text) if t in by_hlo), "other")
                times[stage] += ev.duration_ns / 1e6
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not spans:
        raise ValueError("the trace holds no GPU stream events")
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    return {
        "stage_ms": {k: round(v, 4) for k, v in times.items()},
        "window_ms": window / 1e6,
        "busy_ms": busy / 1e6,
        "idle_share": 1.0 - busy / window if window else 0.0,
    }


def dump_trace_sample(trace_dir: str, path: str, n: int = 40) -> None:
    """Write the plane/line names and the first ``n`` events of each GPU
    line (name, duration, stats) to ``path`` — for reading a trace by hand
    before trusting :func:`stage_device_times` on it."""
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    pd = ProfileData.from_file(max(paths, key=os.path.getmtime))
    with open(path, "w") as f:
        for plane in pd.planes:
            f.write(f"PLANE {plane.name}\n")
            for line in plane.lines:
                evs = list(line.events)
                f.write(f"  LINE {line.name} ({len(evs)} events)\n")
                if plane.name.startswith("/device:GPU"):
                    for ev in evs[:n]:
                        f.write(f"    {ev.name} {ev.duration_ns} ns "
                                f"{[str(st) for st in ev.stats]}\n")
