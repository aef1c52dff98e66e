"""Receiver characterization: performance vs input carrier-to-noise ratio.

Sweeps AWGN over the synthetic modulator (io/synth.py) and measures, at each
CNR point, what a radio datasheet would quote — audio tone SNR, stereo
separation, RDS block/group error rates.  The reference has no equivalent
(its only validation is listening to off-air recordings, SURVEY.md §4); this
pins the whole demodulation chain's sensitivity floor and detects regressions
in the loops' acquisition behavior that clean-signal tests can't see.

CNR here is carrier power over noise power in the FULL 1.024 MHz capture
bandwidth (complex AWGN, u8-quantized like the radio front end would).

Usage:
    python tools/characterize.py [--cnrs 10,15,20,30,40] [--seconds 1.0]
        [--block 32768] [--json out.jsonl] [--markdown]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fm_radio.io.pcm import c64_to_u8, u8_to_c64  # noqa: E402
from fm_radio.io.synth import FMModulator, ModulatorConfig  # noqa: E402
from fm_radio.models.app import App  # noqa: E402

GROUPS = [
    (0x1234, (0 << 12) | (1 << 10) | 0b00000, 0xE101, 0x4142),  # 0A
    (0x1234, (2 << 12) | 0b00000, 0x4845, 0x4C4C),              # 2A
]


def tone_snr_db(x: np.ndarray, fs: float, f0: float) -> float:
    """Least-squares tone fit -> SNR of fit vs residual (test_e2e style)."""
    t = np.arange(len(x)) / fs
    basis = np.stack([np.sin(2 * np.pi * f0 * t), np.cos(2 * np.pi * f0 * t)])
    coefs, *_ = np.linalg.lstsq(basis.T, x.astype(np.float64), rcond=None)
    fit = basis.T @ coefs
    err = x - fit
    return 10 * np.log10(np.sum(fit**2) / (np.sum(err**2) + 1e-20))


def tone_power_ratio_db(x, fs, f0, bw=100.0):
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
    freqs = np.fft.rfftfreq(len(x), 1 / fs)
    band = (freqs > f0 - bw) & (freqs < f0 + bw)
    return 10 * np.log10(spec[band].sum() / spec.sum())


def apply_impairments(iq: np.ndarray, fs: float, freq_offset_hz: float,
                      echo_delay_us: float, echo_db: float) -> np.ndarray:
    """Optional channel impairments applied before noise:

    * carrier frequency offset (receiver tuning error) — FM-demodulates to
      a DC shift in the discriminator output (the pilot tone itself stays at
      19 kHz, so stereo survives small offsets — measured); LARGE offsets
      (tens of kHz) push the signal against the ↓4 front-end LPF edge;
    * one static multipath echo at ``echo_delay_us`` / ``echo_db`` below
      the main path (urban reflection model).
    """
    if freq_offset_hz:
        n = np.arange(iq.size)
        iq = iq * np.exp(2j * np.pi * freq_offset_hz * n / fs)
    if echo_db > -90.0:
        d = max(int(round(echo_delay_us * 1e-6 * fs)), 1)
        g = 10.0 ** (echo_db / 20.0)
        echo = np.zeros_like(iq)
        echo[d:] = iq[:-d]
        iq = iq + g * echo
    return iq.astype(np.complex64)


def run_point(iq_clean: np.ndarray, cnr_db: float, block: int,
              seed: int, ingest: str = "c64") -> dict:
    # per-point generator: a point's noise realization is a function of
    # (seed, cnr) alone, independent of which other points are in the sweep
    rng = np.random.default_rng([seed, int(cnr_db * 10)])
    amp = float(np.mean(np.abs(iq_clean)))  # constant-envelope carrier
    # CNR = A^2 / (2 sigma^2)  ->  sigma = A / sqrt(2 * 10^(CNR/10))
    sigma = amp / np.sqrt(2.0 * 10.0 ** (cnr_db / 10.0))
    noise = sigma * (rng.standard_normal(iq_clean.size)
                     + 1j * rng.standard_normal(iq_clean.size))
    noisy = (iq_clean + noise.astype(np.complex64)).astype(np.complex64)
    # u8 front-end quantization round trip (clipping included)
    u8 = c64_to_u8(noisy)

    app = App(block_size=block, channels=1)
    if ingest == "i8":
        # the production ingest: the capture's bytes as int8 planes
        from fm_radio.utils.transfer import split_iq_i8

        app.process(split_iq_i8(u8.reshape(-1, 2))[:, None, :])
    else:
        app.process(u8_to_c64(u8))

    fs_audio = app.demod.fs_audio
    audio = app.audio[0]
    settle = int(0.2 * fs_audio)
    left, right = audio[settle:, 0], audio[settle:, 1]

    chain = app.rds_chains[0].chain
    blocks_total = sum(len(g) for g in chain.groups)
    blocks_bad = sum(1 for g in chain.groups for b in g if not b.is_valid)
    groups_ok = sum(1 for g in chain.groups if all(b.is_valid for b in g))
    sep = (tone_power_ratio_db(right, fs_audio, 3000.0)
           - tone_power_ratio_db(left, fs_audio, 3000.0))
    return {
        "cnr_db": cnr_db,
        "audio_snr_db": round(float(tone_snr_db(left, fs_audio, 1000.0)), 1),
        "stereo_sep_db": round(float(sep), 1),
        "rds_groups_ok": groups_ok,
        "rds_block_error_rate": round(blocks_bad / blocks_total, 3)
        if blocks_total else 1.0,
        "pi_decoded": app.rds_database(0).pi_code == 0x1234,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cnrs", default="10,15,20,25,30,40",
                    help="comma-separated CNR points in dB")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--block", type=int, default=32768)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--freq-offset-hz", type=float, default=0.0,
                    help="carrier offset (front-end passband margin test)")
    ap.add_argument("--echo-delay-us", type=float, default=5.0,
                    help="multipath echo delay")
    ap.add_argument("--echo-db", type=float, default=-100.0,
                    help="echo level vs main path (> -90 enables it)")
    ap.add_argument("--ingest", default="c64", choices=("c64", "i8"),
                    help="i8 = production int8-plane ingest (the "
                         "bench/headline path)")
    ap.add_argument("--json", default=None, help="write JSONL to this path")
    ap.add_argument("--markdown", action="store_true",
                    help="print a markdown table")
    args = ap.parse_args(argv)

    n = int(args.seconds * 1_024_000) // args.block * args.block
    mod = FMModulator(ModulatorConfig())
    iq_clean = mod.generate(n, left_hz=1000.0, right_hz=3000.0,
                            rds_groups=GROUPS)
    if args.freq_offset_hz or args.echo_db > -90.0:
        iq_clean = apply_impairments(iq_clean, mod.cfg.fs,
                                     args.freq_offset_hz,
                                     args.echo_delay_us, args.echo_db)
    rows = []
    for cnr in [float(s) for s in args.cnrs.split(",")]:
        t0 = time.time()
        row = run_point(iq_clean, cnr, args.block, args.seed, args.ingest)
        rows.append(row)
        print(f"# CNR {cnr:5.1f} dB -> {row}  ({time.time()-t0:.1f}s)",
              file=sys.stderr)

    if args.json:
        with open(args.json, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    if args.markdown:
        print("| CNR (dB) | audio SNR (dB) | stereo sep (dB) "
              "| RDS groups | RDS BLER | PI |")
        print("|---|---|---|---|---|---|")
        for r in rows:
            print(f"| {r['cnr_db']:.0f} | {r['audio_snr_db']} "
                  f"| {r['stereo_sep_db']} | {r['rds_groups_ok']} "
                  f"| {r['rds_block_error_rate']} "
                  f"| {'ok' if r['pi_decoded'] else '—'} |")
    else:
        for r in rows:
            print(json.dumps(r))


if __name__ == "__main__":
    main()
