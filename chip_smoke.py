"""Smoke check of the stereo+RDS demod chain on one GPU, at full width.

    python chip_smoke.py            # one card
    python chip_smoke.py --multi    # four cards: the sharded paths only

Phases of the default run (any failure exits non-zero; nothing is caught
and passed over):

1. The device: JAX's backend must be ``gpu``; prints the card's name and
   power limit.
2. The card-only accuracy tests (``pytest -m gpu``, tests/test_gpu_accuracy.py).
3. The main path at full width, through the user entry points:
   a. ``demod_block`` on 2048 stations x 131,072-sample blocks of int8 IQ
      planes, a jitted ``lax.scan`` over the blocks with the state carried.
      Eight distinct synthetic stereo+RDS stations fill the 2048 channels.
      Gates: finite audio everywhere; pilot PLL locked; stereo separation;
      RDS groups bit-exact against the transmitted schedule; every channel
      equal to its station's first channel; and a subset of channels against
      the plain float ``ops/`` path (lax.scan loops, f32 products) run on
      the CPU, within AUDIO_SNR_MIN_DB and RDS_AGREE_MIN.
   b. ``wideband_demod_block`` at m = 32 channels x 64 captures (2048
      stations): the stations of the capture decode bit-exact RDS.
   c. ``fmtpu selftest`` and ``fmtpu synth`` + ``fmtpu stations --auto``
      through the CLI and ``App``.
4. Each serial-loop kernel against its ``lax.scan`` at real widths, and the
   end-to-end ``demod_block`` time with kernels and with scans at C = 1
   (65,536-sample blocks) and C = 2048 (131,072).

``--multi`` runs only ``demod_channels_sharded`` and ``demod_time_parallel``
(ppermute halo) on four cards against the sequential stream.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import sys
import tempfile
import time

import jax
import numpy as np

# Audio of the card's production path against the plain float path on the
# CPU, per channel, after the loops settle.  The kernel's PLL phase
# detector (angle outside the loop) differs from the scan's by ~1e-7 cycles
# per step, the same bound as the card's kernel-vs-scan gate
# (tests/test_gpu_accuracy.py); the filter products add ~100 dB-down error
# at bf16x3 (PERF.md, precision decision).
AUDIO_SNR_MIN_DB = 45.0
# Share of RDS symbol decisions (valid mask and sign) on which the card
# and the CPU float path agree, after the loops settle.
RDS_AGREE_MIN = 0.999
STEREO_SEP_MIN_DB = 20.0
SETTLE_S = 0.25          # loop settling skipped before comparing audio
# RDS acquisition budget (pilot PLL + BPSK TED + group sync) before the
# transmitted schedule must decode group for group; measured on the CPU
# float path, the slowest of the eight stations needs ~0.45 s
ACQ_S = 0.5

N_STATIONS = 8
BASE_PI = 0x5000
FS = 1_024_000


def log(msg: str) -> None:
    print(msg, flush=True)


def station_iq(k: int, n: int):
    """Station k: distinct PI, PS and tones, 4 repeating 0A groups."""
    from fm_radio.io.synth import FMModulator, ModulatorConfig

    pi = BASE_PI + k
    groups = [(pi, (0 << 12) | (1 << 10) | seg, 0xE101 + k, 0x4141 + seg)
              for seg in range(4)]
    iq = FMModulator(ModulatorConfig()).generate(
        n, left_hz=700.0 + 100.0 * k, right_hz=2500.0 + 150.0 * k,
        rds_groups=groups)
    return iq, set(groups)


def tone_db(x, f0, fs, bw=60.0):
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
    freqs = np.fft.rfftfreq(len(x), 1 / fs)
    band = (freqs > f0 - bw) & (freqs < f0 + bw)
    return 10 * np.log10(spec[band].sum() / (spec.sum() + 1e-30) + 1e-30)


def separation_db(audio, k, fs):
    """min over the two tones of (wanted side - other side) tone share."""
    lf, rf = 700.0 + 100.0 * k, 2500.0 + 150.0 * k
    left, right = audio[:, 0], audio[:, 1]
    return min(tone_db(left, lf, fs) - tone_db(right, lf, fs),
               tone_db(right, rf, fs) - tone_db(left, rf, fs))


def rds_groups(pred, valid):
    from fm_radio.rds.chain import RDSFullChain

    chain = RDSFullChain()
    chain.process_symbols(pred[valid.astype(bool)])
    full = [tuple(b.data for b in g) for g in chain.chain.groups
            if all(b.is_valid for b in g)]
    return full, chain.db.pi_code


def check_rds(pred, valid, tx, pi, seconds, what):
    got, pi_rx = rds_groups(pred, valid)
    floor = int((seconds - ACQ_S) * (1187.5 / 104.0)) - 1
    assert pi_rx == pi, f"{what}: PI {pi_rx:04X} != {pi:04X}"
    assert set(got) <= tx, f"{what}: untransmitted groups {set(got) - tx}"
    assert len(got) >= floor, f"{what}: {len(got)} groups < floor {floor}"
    return len(got)


def snr_db(ref, x):
    err = float(((x - ref) ** 2).sum())
    return 10 * np.log10(float((ref ** 2).sum()) / max(err, 1e-30))


@functools.partial(jax.jit, static_argnames="cfg")
def run_blocks(cfg, coeffs, state, xs):
    """lax.scan of demod_block over xs [nb, ...]; returns the final state
    and stacked audio / rds_pred / rds_valid."""
    from fm_radio.models.demod import demod_block

    def body(s, x):
        s, o = demod_block(cfg, coeffs, s, x)
        return s, (o["audio"], o["rds_pred"], o["rds_valid"])

    return jax.lax.scan(body, state, xs)


def unblock(y):
    """[nb, C, n, ...] -> [C, nb*n, ...]"""
    y = jax.numpy.moveaxis(y, 0, 1)
    return y.reshape(y.shape[0], -1, *y.shape[3:])


# ---------------------------------------------------------------- phase 2
def phase_gpu_tests() -> None:
    import pytest

    os.environ["FMTPU_GPU_TESTS"] = "1"
    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-s", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(here, "tests", "test_gpu_accuracy.py")])
    assert rc == 0, f"card-only accuracy tests failed (pytest exit {rc})"


# --------------------------------------------------------------- phase 3a
def tile_state(state, channels):
    """A state of the N_STATIONS stations -> ``channels`` channels, channel
    c carrying station c % N_STATIONS (leaves are [K, ...] or stacked
    re/im [2K, ...])."""
    idx = np.arange(channels) % N_STATIONS

    def tile(a):
        a = np.asarray(a)
        if a.shape[0] == N_STATIONS:
            return a[idx]
        k2 = a.reshape(2, N_STATIONS, *a.shape[1:])[:, idx]
        return k2.reshape(2 * channels, *a.shape[1:])

    return jax.tree.map(tile, state)


@contextlib.contextmanager
def float_reference():
    """The plain float path: lax.scan loops, every filter product at
    Precision.HIGHEST, on the CPU."""
    from fm_radio.config import DemodConfig
    from fm_radio.ops import fir, iir

    saved = fir.FIR_PRECISION, iir.IIR_PRECISION
    fir.FIR_PRECISION = iir.IIR_PRECISION = jax.lax.Precision.HIGHEST
    try:
        with jax.default_device(jax.devices("cpu")[0]):
            yield DemodConfig(loop_impl="scan")
    finally:
        fir.FIR_PRECISION, iir.IIR_PRECISION = saved


def as_blocks(x8, block):
    """[2, K, n] int8 -> [n // block, 2, K, block] (numpy)."""
    k, n = x8.shape[1], x8.shape[2]
    return np.moveaxis(x8.reshape(2, k, n // block, block), 2, 0)


def phase_presplit(channels=2048, block=131072, n_blocks=12,
                   acq_block=65536, acq_blocks=8):
    """The production shape from a locked state.  The stations are first
    acquired on the CPU float path at 65,536-sample blocks: from a cold
    start at 131,072-sample blocks the reference's once-per-block L-R
    phase law settles on its inverted stable point for these stations
    (PERF.md), so acquisition runs at the reference's default block size
    and the production-shape run continues from that carried state."""
    import jax.numpy as jnp

    from fm_radio.config import DemodConfig
    from fm_radio.io.pcm import c64_to_u8
    from fm_radio.models.demod import demod_init_state, make_coeffs
    from fm_radio.utils.transfer import split_iq_i8

    n_acq = acq_block * acq_blocks
    n = block * n_blocks
    seconds = n / FS
    stations = [station_iq(k, n_acq + n) for k in range(N_STATIONS)]
    x8 = np.stack([split_iq_i8(c64_to_u8(iq.astype(np.complex64)))
                   for iq, _ in stations], axis=1)          # [2, K, n] int8

    # acquisition + the float reference of the production-shape run
    with float_reference() as cfg_ref:
        co_ref = make_coeffs(cfg_ref)
        st_acq, _ = run_blocks(cfg_ref, co_ref,
                               demod_init_state(cfg_ref, N_STATIONS),
                               as_blocks(x8[:, :, :n_acq], acq_block))
        _, (a_ref, p_ref, v_ref) = run_blocks(
            cfg_ref, co_ref, st_acq, as_blocks(x8[:, :, n_acq:], block))
        a_ref, p_ref, v_ref = (np.asarray(unblock(y))
                               for y in (a_ref, p_ref, v_ref))
        st0 = tile_state(st_acq, channels)

    cfg = DemodConfig()
    coeffs = make_coeffs(cfg)
    # channel c carries station c % K; blocks leading for the scan
    xs = jnp.take(jnp.asarray(as_blocks(x8[:, :, n_acq:], block)),
                  jnp.arange(channels) % N_STATIONS, axis=2)  # [nb, 2, C, B]
    st0 = jax.device_put(st0)
    t0 = time.perf_counter()
    jax.block_until_ready(run_blocks(cfg, coeffs, st0, xs))
    t1 = time.perf_counter()
    st, (audio, pred, valid) = run_blocks(cfg, coeffs, st0, xs)
    jax.block_until_ready(audio)
    t2 = time.perf_counter()
    log(f"[3a] demod_block C={channels} B={block} x{n_blocks} blocks: "
        f"first run {t1 - t0:.1f} s (compile included), second "
        f"{(t2 - t1) / n_blocks * 1e3:.3f} ms/block")
    del xs
    audio, pred, valid = unblock(audio), unblock(pred), unblock(valid)

    assert bool(jnp.isfinite(audio).all()), "non-finite audio"
    pe = float(jnp.abs(st["pll"].prev_pe).max())
    assert pe < 0.5, f"pilot PLL not locked: max |phase error| {pe:.3f} rad"
    fs_a = cfg.rates.fs_audio
    skip_a = int(SETTLE_S * fs_a)
    # every channel equals its station's first channel (same bytes in)
    first = jnp.arange(channels) % N_STATIONS
    worst = float(jnp.abs(audio - audio[first]).max())
    assert worst < 1e-3, f"channels of one station differ by {worst:.2e}"

    subset = sorted({*range(N_STATIONS),
                     *range(channels - N_STATIONS, channels)})
    a_sub = np.asarray(audio[np.asarray(subset)])
    p_sub = np.asarray(pred[np.asarray(subset)])
    v_sub = np.asarray(valid[np.asarray(subset)])
    skip_r = int(SETTLE_S * cfg.rates.fs_rds)
    worst_snr, worst_agree, worst_sep, n_groups = np.inf, 1.0, np.inf, []
    for i, c in enumerate(subset):
        k = c % N_STATIONS
        sep = separation_db(a_sub[i, skip_a:], k, fs_a)
        n_groups.append(check_rds(p_sub[i], v_sub[i], stations[k][1],
                                  BASE_PI + k, seconds, f"channel {c}"))
        s = snr_db(a_ref[k, skip_a:], a_sub[i, skip_a:])
        agree = float(np.mean(
            (v_sub[i, skip_r:] == v_ref[k, skip_r:])
            & (np.sign(p_sub[i, skip_r:]) == np.sign(p_ref[k, skip_r:]))))
        worst_snr, worst_agree = min(worst_snr, s), min(worst_agree, agree)
        worst_sep = min(worst_sep, sep)
    log(f"[3a] vs the CPU float path on {len(subset)} channels: worst audio "
        f"SNR {worst_snr:.2f} dB (min {AUDIO_SNR_MIN_DB}), worst RDS symbol "
        f"agreement {worst_agree:.6f} (min {RDS_AGREE_MIN}); worst stereo "
        f"separation {worst_sep:.1f} dB; bit-exact RDS groups per channel "
        f"{min(n_groups)}..{max(n_groups)}; channels-of-one-station max diff "
        f"{worst:.2e}; PLL max |pe| {pe:.3f}")
    assert worst_sep > STEREO_SEP_MIN_DB, f"separation {worst_sep:.1f} dB"
    assert worst_snr > AUDIO_SNR_MIN_DB, f"audio SNR {worst_snr:.2f} dB"
    assert worst_agree >= RDS_AGREE_MIN, f"RDS agreement {worst_agree:.6f}"


# --------------------------------------------------------------- phase 3b
def phase_wideband(m=32, captures=64, block=131072, n_blocks=12):
    import jax.numpy as jnp

    from fm_radio.config import DemodConfig
    from fm_radio.io.pcm import c64_to_u8
    from fm_radio.io.synth import make_wideband
    from fm_radio.models.demod import make_coeffs
    from fm_radio.models.wideband import wideband_demod_block, wideband_init_state
    from fm_radio.parallel.channelizer import make_channelizer_taps
    from fm_radio.utils.transfer import pack_iq_u8

    n = block * n_blocks
    seconds = n / FS
    bins = {1: 0, 5: 1, 12: 2, 27: 3}        # channel -> station index
    stations = {ch: station_iq(k, n) for ch, k in bins.items()}
    wide = make_wideband({ch: iq for ch, (iq, _) in stations.items()}, m)
    wide *= 100.0 / np.abs(wide).max()
    words = pack_iq_u8(c64_to_u8(wide.astype(np.complex64)))   # [m*n] f32
    del wide

    cfg = DemodConfig()
    coeffs = make_coeffs(cfg)
    taps = make_channelizer_taps(m)
    w = jnp.asarray(words).reshape(n_blocks, 1, m * block)
    ws = jnp.broadcast_to(w, (n_blocks, captures, m * block))

    @jax.jit
    def run(st, ws):
        def body(s, wb):
            s, o = wideband_demod_block(cfg, coeffs, taps, s, wb, m)
            return s, (o["audio"], o["rds_pred"], o["rds_valid"])

        return jax.lax.scan(body, st, ws)

    t0 = time.perf_counter()
    _, (audio, pred, valid) = run(wideband_init_state(cfg, m, captures), ws)
    jax.block_until_ready(audio)
    log(f"[3b] wideband m={m} x {captures} captures ({m * captures} "
        f"stations) x{n_blocks} blocks: {time.perf_counter() - t0:.1f} s "
        "incl. compile")
    audio, pred, valid = unblock(audio), unblock(pred), unblock(valid)
    assert bool(jnp.isfinite(audio).all()), "non-finite wideband audio"
    counts = []
    for cap in (0, captures - 1):
        for ch, (_, tx) in stations.items():
            c = cap * m + ch
            counts.append(check_rds(np.asarray(pred[c]), np.asarray(valid[c]),
                                    tx, BASE_PI + bins[ch], seconds,
                                    f"capture {cap} channel {ch}"))
    log(f"[3b] bit-exact RDS groups per station {min(counts)}..{max(counts)}")


# --------------------------------------------------------------- phase 3c
def cli(argv):
    from fm_radio.apps.cli import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            main(argv)
        except SystemExit as e:
            raise AssertionError(f"fmtpu {argv[0]} exited {e.code}: "
                                 f"{out.getvalue()[-2000:]}") from None
    return out.getvalue()


def phase_cli(tmp):
    res = json.loads(cli(["selftest", "--seconds", "2"]).strip().splitlines()[-1])
    assert res["pass"] and res["backend"] == jax.default_backend(), res
    log(f"[3c] fmtpu selftest: pass, separation "
        f"{res['checks']['stereo_separation_db']['value']} dB, "
        f"{res['checks']['rds_groups']['value']} RDS groups")
    wide = os.path.join(tmp, "wide.pcm")
    cli(["synth", "-o", wide, "--stations", "4", "-m", "8", "--seconds", "1.5"])
    summary = json.loads(cli(["stations", "-i", wide, "-o",
                              os.path.join(tmp, "stations"), "-m", "8",
                              "--auto"]))
    got = {s["channel"]: (s["pi_code"], s["service_name"]) for s in summary}
    want = {k + 1: (f"{0x1234 + k:04X}", f"ST {k + 1:02d}".ljust(8))
            for k in range(4)}
    assert got == want, f"fmtpu stations: {got} != {want}"
    log(f"[3c] fmtpu stations --auto: {sorted(got)} decode their PI/PS")


# ---------------------------------------------------------------- phase 4
def phase_kernels(pll_shapes=((1, 8192), (2048, 16384)),
                  bpsk_shapes=((1, 1024), (2048, 2048)),
                  e2e_shapes=((1, 65536, 8), (2048, 131072, 4))):
    import jax.numpy as jnp

    from bench import make_input, make_run, time_run
    from fm_radio.config import DemodConfig
    from fm_radio.kernels.bpsk_pallas import bpsk_sync_pallas
    from fm_radio.kernels.pll_pallas import pilot_pll_pallas
    from fm_radio.models.bpsk import bpsk_init_state, bpsk_sync_scan
    from fm_radio.models.demod import demod_init_state, make_coeffs
    from fm_radio.models.pilot_pll import pilot_pll_init_state, pilot_pll_scan

    cfg = DemodConfig()
    co = make_coeffs(cfg)
    key = jax.random.PRNGKey(1)
    for c, n in pll_shapes:
        t = jnp.arange(n) / 128000.0
        ph = 2 * jnp.pi * 19010.0 * t[None] + jnp.cumsum(
            0.01 * jax.random.normal(key, (c, n)), -1)
        pil = jnp.exp(1j * ph).astype(jnp.complex64)
        st = pilot_pll_init_state(c)
        fk = jax.jit(lambda s, p: pilot_pll_pallas(cfg, s, p))
        fs = jax.jit(lambda s, p: pilot_pll_scan(co.pll, s, p))
        (_, dk), tk = _timed(fk, st, pil)
        (_, taps), ts = _timed(fs, st, pil)
        d = dk - taps["dt"]
        err = float(jnp.abs(d - jnp.round(d)).max())
        assert err < 1e-4, f"PLL kernel vs scan C={c}: {err:.2e} cycles"
        log(f"[4] pilot PLL C={c} N={n}: kernel {tk * 1e3:.3f} ms, scan "
            f"{ts * 1e3:.3f} ms, max |dt diff| {err:.2e} cycles")
    for c, n in bpsk_shapes:
        bits = jnp.sign(jax.random.normal(key, (c, n // 8 + 1)))
        q = jnp.repeat(bits, 8, axis=1)[:, :n]
        x = (0.05 * jax.random.normal(key, (c, n)) + 1j * q).astype(
            jnp.complex64)
        st = bpsk_init_state(c)
        fk = jax.jit(lambda s, p: bpsk_sync_pallas(cfg, s, p))
        fs = jax.jit(lambda s, p: bpsk_sync_scan(co.bpsk, s, p))
        (_, ok), tk = _timed(fk, st, x)
        (_, os_), ts = _timed(fs, st, x)
        mism = int((ok["valid"] != os_["valid"]).sum())
        err = float(jnp.abs(ok["pred"] - os_["pred"]).max())
        assert mism == 0 and err < 1e-4, f"BPSK C={c}: {mism} / {err:.2e}"
        log(f"[4] BPSK sync C={c} N={n}: kernel {tk * 1e3:.3f} ms, scan "
            f"{ts * 1e3:.3f} ms, valid mismatches {mism}, max |pred diff| "
            f"{err:.2e}")
    for c, b, nb in e2e_shapes:
        x = make_input(c, b)
        ms = {}
        for impl in ("pallas", "scan"):
            cf = DemodConfig(loop_impl=impl)
            run = make_run(cf, make_coeffs(cf), nb)
            ms[impl] = time_run(run, demod_init_state(cf, c), x, 2) / nb * 1e3
        log(f"[4] demod_block end to end C={c} B={b}: kernels "
            f"{ms['pallas']:.3f} ms/block, scans {ms['scan']:.3f} ms/block "
            f"(real time {b / FS * 1e3:.1f} ms)")
        assert ms["pallas"] < ms["scan"], f"kernel path slower at C={c}"


def _timed(f, *a, reps=3):
    out = jax.block_until_ready(f(*a))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(f(*a))
        best = min(best, time.perf_counter() - t0)
    return out, best


# ------------------------------------------------------------------ multi
def phase_multi(c=2048, b=131072):
    """demod_channels_sharded over four cards against each quarter of the
    channels run on one card, then demod_time_parallel's ppermute halo
    against the sequential stream (__graft_entry__.dryrun_multichip:
    PI, word-exact groups, <= 2 groups lost per seam)."""
    from __graft_entry__ import dryrun_multichip
    from bench import make_input
    from fm_radio.config import DemodConfig
    from fm_radio.models.demod import demod_block, demod_init_state, make_coeffs
    from fm_radio.parallel.sharding import demod_channels_sharded, make_mesh

    n_dev = len(jax.devices())
    assert n_dev == 4, f"--multi needs 4 cards, found {n_dev}"
    cfg = DemodConfig()
    co = make_coeffs(cfg)
    x = make_input(c, b)
    _, o_sh = demod_channels_sharded(cfg, co, demod_init_state(cfg, c), x,
                                     make_mesh(n_dev, 1))
    a_sh, v_sh = np.asarray(o_sh["audio"]), np.asarray(o_sh["rds_valid"])
    per = c // n_dev
    err, agree = 0.0, 1.0
    for d in range(n_dev):
        sl = slice(d * per, (d + 1) * per)
        _, o = demod_block(cfg, co, demod_init_state(cfg, per), x[:, sl])
        err = max(err, float(np.abs(a_sh[sl] - np.asarray(o["audio"])).max()))
        agree = min(agree, float(np.mean(v_sh[sl] == np.asarray(o["rds_valid"]))))
    log(f"[multi] demod_channels_sharded C={c} B={b} over {n_dev} cards vs "
        f"one card per quarter: max |audio diff| {err:.2e}, RDS valid "
        f"agreement {agree:.6f}")
    assert err < 1e-3 and agree == 1.0
    dryrun_multichip(n_dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded paths")
    args = ap.parse_args(argv)

    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    log(f"[1] devices: {devs}")
    if info["platform"] != "gpu":
        log(f"[1] FAIL: JAX found no GPU (backend {info['platform']!r})")
        return 2

    from fm_radio.utils.cache import enable_persistent_cache
    from fm_radio.utils.gpu import card_line

    enable_persistent_cache()
    log(f"[1] card: {card_line()}")
    t0 = time.perf_counter()
    if args.multi:
        phase_multi()
    else:
        phase_gpu_tests()
        log(f"[2] card-only accuracy tests passed ({time.perf_counter() - t0:.0f} s)")
        phase_presplit()
        phase_wideband()
        with tempfile.TemporaryDirectory(
                dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
            phase_cli(tmp)
        phase_kernels()
    log(f"all phases passed in {time.perf_counter() - t0:.0f} s")
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
