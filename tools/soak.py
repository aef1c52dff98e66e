"""Unattended serving soak: long-running streaming stability gate.

Streams a synthetic multi-station wideband capture through the production
pipeline (packed u8 ingest -> chunked polyphase FFT channelizer -> one
channel-batched demod -> host RDS decode) in a loop, draining outputs with
the bounded-memory ``App.drain`` API, and gates what a long-running serving
deployment actually needs:

  1. throughput does not degrade over time (no growing per-dispatch cost);
  2. host RSS stays bounded (no accumulation leaks — the reference's
     equivalent discipline is its fixed ring buffers, ring_buffer.h:77-135);
  3. RDS groups keep decoding every window on every station (the pipeline
     is still *working*, not just moving bytes);
  4. audio stays finite (no NaN creep through the carried loop state).

The capture loops with a phase discontinuity at each wrap; PLL/TED re-lock
within ~0.2 s, which the per-window group gate tolerates by construction
(windows are whole capture passes).

Usage:
    python tools/soak.py [--passes 10 | --minutes 30] [--stations 4]
                         [--channels 8] [--seconds 2.0] [--json out.jsonl]

Runs on whatever backend JAX selects (the GPU by default; the CPU with
JAX_PLATFORMS=cpu).  Exit 0 = all gates pass.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return float(line.split()[1]) / 1024.0
    return 0.0


def build_capture(seconds: float, n_stations: int, m: int) -> np.ndarray:
    """Packed-word wideband capture with ``n_stations`` complete stereo+RDS
    stations on the channelizer grid (channels 1..n_stations)."""
    from fm_radio.io.pcm import c64_to_u8
    from fm_radio.io.synth import (
        FMModulator,
        ModulatorConfig,
        make_wideband,
        station_group_schedule,
    )
    from fm_radio.utils.transfer import pack_iq_u8

    n = int(seconds * 1_024_000)
    station_iq = {}
    for k in range(n_stations):
        mod = FMModulator(ModulatorConfig())
        groups = station_group_schedule(
            0x5000 + k, ps=f"SOAK {k:02d}", rt="soak stability run"
        )
        station_iq[k + 1] = mod.generate(
            n, left_hz=1000.0 * (k + 1), right_hz=2500.0, rds_groups=groups
        )
    wide = make_wideband(station_iq, m)
    peak = max(float(np.abs(wide.real).max()), float(np.abs(wide.imag).max()))
    wide *= 120.0 / max(peak, 1e-9)
    return pack_iq_u8(c64_to_u8(wide))


def run(args: argparse.Namespace) -> int:
    from fm_radio.models.app import App
    from fm_radio.parallel.channelizer import (
        channelizer_init_state,
        make_channelizer_taps,
        stream_selected,
    )

    m, n_st = args.channels, args.stations
    assert 1 <= n_st < m, "stations must fit the channel grid (1..m-1)"
    if args.rds_backend == "native":
        # refuse a silent Python-chain substitution (make_rds_chain's
        # fallback): a soak meant to gate the native serving path must not
        # greenlight the wrong backend
        from fm_radio import runtime as rt

        assert rt.available(), "--rds-backend native: runtime not buildable"
    w = build_capture(args.seconds, n_st, m)
    select = list(range(1, n_st + 1))

    app = App(block_size=args.block_size, channels=n_st, decode_rds=True,
              rds_backend=args.rds_backend)
    taps = make_channelizer_taps(m, args.taps_per_phase)
    ch_state = channelizer_init_state(m, args.taps_per_phase)
    n = (len(w) // m) * m

    deadline = time.monotonic() + args.minutes * 60 if args.minutes else None
    sink = open(args.json, "w") if args.json else None
    windows = []
    failures = []
    try:
        p = 0
        while True:
            t0 = time.monotonic()
            ch_state = stream_selected(
                taps, ch_state, w, m, select, app.process,
                chunk_min=m * args.block_size,
            )
            dt = time.monotonic() - t0

            out = app.drain()
            groups = [len(lines) for lines in out["log_lines"]]
            finite = bool(np.isfinite(out["audio"]).all())
            rec = {
                "window": p,
                "wall_s": round(dt, 3),
                "msps": round(n / dt / 1e6, 3),
                "rss_mb": round(_rss_mb(), 1),
                "groups": groups,
                "audio_samples": int(out["audio"].shape[1]),
                "finite": finite,
            }
            windows.append(rec)
            line = json.dumps(rec)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()

            if not finite:
                failures.append(f"window {p}: non-finite audio")
                break
            # gate 3: every station keeps decoding groups, every window
            # (capture carries a full group cycle; re-lock after the wrap
            # costs ~0.2 s of the window by construction)
            bad = [i for i, g in enumerate(groups) if g == 0]
            if bad:
                failures.append(f"window {p}: stations {bad} decoded 0 groups")

            p += 1
            if deadline is not None:
                # never stop before the throughput/RSS gates have enough
                # windows to evaluate (>=3) — a wall-clock soak must not
                # pass with its headline gates silently skipped
                if time.monotonic() >= deadline and p >= 3:
                    break
            elif p >= args.passes:
                break
    finally:
        if sink:
            sink.close()

    # gate 1: throughput stability — settled windows (>=1, first pass pays
    # compile) must not degrade below the early settled rate
    if len(windows) >= 3:
        early = max(w_["msps"] for w_ in windows[1:3])
        late = min(w_["msps"] for w_ in windows[-2:])
        if late < args.throughput_floor * early:
            failures.append(
                f"throughput degraded: early {early} -> late {late} Msps"
            )
    # gate 2: bounded memory after the first settled window
    if len(windows) >= 3:
        grow = windows[-1]["rss_mb"] - windows[1]["rss_mb"]
        if grow > args.rss_slack_mb:
            failures.append(
                f"RSS grew {grow:.0f} MB > slack {args.rss_slack_mb} MB")

    verdict = {
        "pass": not failures,
        "windows": len(windows),
        "failures": failures,
        "rds_backend": type(app.rds_chains[0]).__name__,
        "stations": {
            f"st{k+1}": app.rds_database(k).summary() for k in range(n_st)
        },
    }
    print(json.dumps(verdict), flush=True)
    return 0 if not failures else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--passes", type=int, default=10,
                    help="number of capture passes (windows)")
    ap.add_argument("--minutes", type=float, default=None,
                    help="wall-clock limit (overrides --passes)")
    ap.add_argument("--stations", type=int, default=4)
    ap.add_argument("--channels", type=int, default=8,
                    help="channelizer bins M")
    ap.add_argument("--seconds", type=float, default=2.0,
                    help="capture length per window")
    ap.add_argument("--block-size", type=int, default=65536)
    ap.add_argument("--taps-per-phase", type=int, default=16)
    ap.add_argument("--rds-backend", default="python",
                    choices=["python", "native"])
    ap.add_argument("--rss-slack-mb", type=float, default=256.0)
    ap.add_argument("--throughput-floor", type=float, default=0.6,
                    help="late/early settled Msps ratio gate")
    ap.add_argument("--json", default=None, help="also write JSONL here")
    return run(ap.parse_args())


if __name__ == "__main__":
    sys.exit(main())
