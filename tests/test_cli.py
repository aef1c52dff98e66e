"""CLI smoke tests: full artifact pipeline (pcm -> wav + rds bytes ->
rds-decode) round-trips through the command-line surface."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from fm_radio.io.pcm import c64_to_u8
from fm_radio.io.synth import FMModulator, ModulatorConfig
from fm_radio.io.wav import read_wav_int16

ENV = dict(
    os.environ,
    JAX_PLATFORMS="cpu",
    XLA_FLAGS="--xla_force_host_platform_device_count=1",
)

BLOCK = 16384


@pytest.fixture(scope="module")
def pcm_file(tmp_path_factory):
    mod = FMModulator(ModulatorConfig())
    groups = [(0xBEEF, (0 << 12) | 0b00000, 0x0000, 0x4654)]  # 0A, name 'FT'
    # ~0.5 s of signal: enough for pilot/TED lock plus a few RDS groups
    iq = mod.generate(BLOCK * 32, left_hz=1000.0, right_hz=1000.0, rds_groups=groups)
    path = tmp_path_factory.mktemp("pcm") / "test.pcm"
    c64_to_u8(iq).tofile(path)
    return str(path)


def run_cli(*args, stdin=None):
    return subprocess.run(
        [sys.executable, "-m", "fm_radio.apps.cli", *args],
        capture_output=True,
        env=ENV,
        input=stdin,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        timeout=600,
    )


def test_scrape_and_rds_decode_roundtrip(pcm_file, tmp_path):
    out = run_cli("scrape", "-i", pcm_file, "-b", str(BLOCK), "-o", str(tmp_path))
    assert out.returncode == 0, out.stderr.decode()
    wavs = [f for f in os.listdir(tmp_path) if f.endswith(".wav")]
    bins = [f for f in os.listdir(tmp_path) if f.endswith(".bin")]
    assert wavs and bins

    audio, fs = read_wav_int16(os.path.join(tmp_path, wavs[0]))
    assert fs == 32000 and audio.shape[1] == 2 and audio.shape[0] > 0

    # replay the RDS bytes through the standalone decoder (rds_decode parity)
    out2 = run_cli("rds-decode", "-i", os.path.join(tmp_path, bins[0]))
    assert out2.returncode == 0, out2.stderr.decode()
    info = json.loads(out2.stdout.decode().strip().splitlines()[-1])
    assert info["pi_code"] == "BEEF"


def test_demod_writes_wav(pcm_file, tmp_path):
    wav = str(tmp_path / "out.wav")
    out = run_cli("demod", "-i", pcm_file, "-b", str(BLOCK), "-o", wav, "--no-rds")
    assert out.returncode == 0, out.stderr.decode()
    audio, fs = read_wav_int16(wav)
    assert fs == 32000 and len(audio) == BLOCK * 32 // 32


@pytest.mark.slow
def test_bench_runs_tiny():
    out = run_cli("bench", "-b", "8192", "-c", "2")
    assert out.returncode == 0, out.stderr.decode()
    info = json.loads(out.stdout.decode().strip().splitlines()[-1])
    assert info["aggregate_msps"] > 0


@pytest.mark.slow
def test_stations_pipeline(tmp_path):
    """Wideband capture -> `fmtpu stations`: channelize + batched demod of
    every station in one command (the framework's headline path)."""
    m, fs_ch = 4, 1_024_000
    n_ch = BLOCK * 40  # ~0.64 s
    n_wide = n_ch * m
    mod = FMModulator(ModulatorConfig())
    groups = [(0xCAFE, (0 << 12) | (1 << 10), 0xE101, 0x5A5A)]
    iq = mod.generate(n_ch, left_hz=800.0, right_hz=1600.0, rds_groups=groups)
    t = np.arange(n_wide) / (fs_ch * m)
    wide = (np.repeat(iq, m)[:n_wide] * np.exp(2j * np.pi * fs_ch * t)).astype(
        np.complex64
    )
    wide /= np.abs(wide).max() / 100.0
    path = tmp_path / "wide.pcm"
    c64_to_u8(wide).tofile(path)

    out = tmp_path / "stations"
    r = run_cli("stations", "-i", str(path), "-o", str(out), "-m", str(m),
                "--select", "1")
    assert r.returncode == 0, r.stderr.decode()
    summary = json.loads(r.stdout.decode())
    assert summary[0]["pi_code"] == "CAFE"
    audio, fs = read_wav_int16(str(out / "station_01.wav"))
    assert fs == 32000 and audio.shape[0] == n_ch // 32


def test_lazy_packed_pcm_matches_eager(tmp_path):
    """LazyPackedPcm (the constant-memory wideband ingest view) slices to
    exactly pack_iq_u8 of the whole file."""
    from fm_radio.io.pcm import LazyPackedPcm
    from fm_radio.utils.transfer import pack_iq_u8

    rng = np.random.default_rng(3)
    u8 = rng.integers(0, 256, 4096 * 2).astype(np.uint8)
    p = tmp_path / "x.pcm"
    u8.tofile(p)
    lz = LazyPackedPcm(str(p))
    full = pack_iq_u8(u8.reshape(-1, 2))
    assert len(lz) == len(full)
    np.testing.assert_array_equal(lz[0:777], full[0:777])
    np.testing.assert_array_equal(lz[777:4096], full[777:4096])
    assert len(LazyPackedPcm(str(p), max_samples=100)) == 100


def test_lazy_i8_pcm_matches_eager(tmp_path):
    """LazyI8Pcm (the round-3 production ingest view) slices to exactly
    split_iq_i8 of the whole file in the [2, 1, M] single-channel form."""
    from fm_radio.io.pcm import LazyI8Pcm
    from fm_radio.utils.transfer import split_iq_i8

    rng = np.random.default_rng(4)
    u8 = rng.integers(0, 256, 4096 * 2).astype(np.uint8)
    p = tmp_path / "x.pcm"
    u8.tofile(p)
    lz = LazyI8Pcm(str(p))
    full = split_iq_i8(u8.reshape(-1, 2))[:, None, :]
    assert len(lz) == full.shape[-1]
    assert lz[0:777].dtype == np.int8 and lz[0:777].shape == (2, 1, 777)
    np.testing.assert_array_equal(lz[0:777], full[:, :, 0:777])
    np.testing.assert_array_equal(lz[777:4096], full[:, :, 777:4096])
    assert len(LazyI8Pcm(str(p), max_samples=100)) == 100


@pytest.mark.slow
def test_scan_finds_and_identifies_stations(tmp_path):
    """`fmtpu scan`: power-detect the active channels in a wideband capture,
    demodulate only those, and identify them (stereo pilot + RDS PI/PS) —
    the automated version of the reference's stare-at-the-baseband-spectrum
    + retune workflow.  `stations --auto` uses the same detector."""
    m, fs_ch = 4, 1_024_000
    n_ch = BLOCK * 40
    n_wide = n_ch * m
    mod = FMModulator(ModulatorConfig())
    groups = [(0xCAFE, (0 << 12) | (1 << 10), 0xE101, 0x5A5A)]
    iq = mod.generate(n_ch, left_hz=800.0, right_hz=1600.0, rds_groups=groups)
    t = np.arange(n_wide) / (fs_ch * m)
    wide = (np.repeat(iq, m)[:n_wide] * np.exp(2j * np.pi * fs_ch * t)).astype(
        np.complex64
    )
    wide /= np.abs(wide).max() / 100.0
    path = tmp_path / "wide.pcm"
    c64_to_u8(wide).tofile(path)

    r = run_cli("scan", "-i", str(path), "-m", str(m), "-b", "32768",
                "--seconds", "0.6")
    assert r.returncode == 0, r.stderr.decode()
    report = json.loads(r.stdout.decode())
    assert report["select"] == "1"
    (st,) = report["active"]
    assert st["channel"] == 1 and st["offset_hz"] == fs_ch
    assert st["above_floor_db"] > 15.0
    assert st["stereo"] and st["pi"] == "CAFE"

    out = tmp_path / "auto"
    r = run_cli("stations", "-i", str(path), "-o", str(out), "-m", str(m),
                "--auto")
    assert r.returncode == 0, r.stderr.decode()
    summary = json.loads(r.stdout.decode())
    assert [s["channel"] for s in summary] == [1]
    assert summary[0]["pi_code"] == "CAFE"


@pytest.mark.slow
def test_demod_checkpoint_resume(pcm_file, tmp_path):
    """Split a stream at a block boundary, checkpoint, resume in a new
    process: concatenated audio == single-pass audio (bit-identical)."""
    data = np.fromfile(pcm_file, np.uint8)
    block_bytes = BLOCK * 2
    split = (len(data) // (2 * block_bytes)) * block_bytes
    p1, p2 = tmp_path / "a.pcm", tmp_path / "b.pcm"
    data[:split].tofile(p1)
    data[split:].tofile(p2)
    ckpt = tmp_path / "state.npz"

    w_full = tmp_path / "full.wav"
    r = run_cli("demod", "-i", pcm_file, "-b", str(BLOCK), "-o", str(w_full), "--no-rds")
    assert r.returncode == 0, r.stderr.decode()

    w1, w2 = tmp_path / "p1.wav", tmp_path / "p2.wav"
    r = run_cli("demod", "-i", str(p1), "-b", str(BLOCK), "-o", str(w1),
                "--no-rds", "--save-state", str(ckpt))
    assert r.returncode == 0, r.stderr.decode()
    r = run_cli("demod", "-i", str(p2), "-b", str(BLOCK), "-o", str(w2),
                "--no-rds", "--resume-state", str(ckpt))
    assert r.returncode == 0, r.stderr.decode()

    full, _ = read_wav_int16(str(w_full))
    a, _ = read_wav_int16(str(w1))
    b, _ = read_wav_int16(str(w2))
    np.testing.assert_array_equal(full, np.concatenate([a, b]))


@pytest.mark.slow
def test_tune_wideband_station(tmp_path):
    """`tune` (fm_demod_tuner for recorded captures): a full station placed
    at +1.024 MHz inside a 4.096 MHz wideband capture must demodulate to its
    tone and PI code after mix-down + decimate."""
    m = 4
    fs_ch = 1_024_000
    n_ch = BLOCK * 32
    mod = FMModulator(ModulatorConfig())
    groups = [(0xCAFE, (0 << 12) | 0b00000, 0x0000, 0x4654)]
    iq = mod.generate(n_ch, left_hz=1500.0, right_hz=1500.0, rds_groups=groups)
    n_wide = n_ch * m
    up = np.repeat(iq, m)[:n_wide]  # ZOH to the wide rate
    t = np.arange(n_wide) / (fs_ch * m)
    wide = (up * np.exp(2j * np.pi * fs_ch * t)).astype(np.complex64)
    path = tmp_path / "wide.pcm"
    c64_to_u8(wide / 2.0).tofile(path)  # headroom for the u8 grid

    out = run_cli(
        "tune", "-i", str(path), "-r", str(fs_ch * m), "-f", str(fs_ch),
        "-b", str(BLOCK), "-o", str(tmp_path / "out"),
    )
    assert out.returncode == 0, out.stderr.decode()
    info = json.loads(out.stdout.decode().strip().splitlines()[-2])
    assert info["pi_code"] == "CAFE"

    wavs = [f for f in os.listdir(tmp_path / "out") if f.endswith(".wav")]
    audio, fs = read_wav_int16(os.path.join(tmp_path / "out", wavs[0]))
    settle = int(0.1 * fs)
    mono = audio[settle:, 0].astype(np.float64)
    spec = np.abs(np.fft.rfft(mono * np.hanning(len(mono))))
    freqs = np.fft.rfftfreq(len(mono), 1 / fs)
    assert abs(freqs[np.argmax(spec)] - 1500.0) < 20.0


@pytest.mark.slow
def test_demod_control_flags(pcm_file, tmp_path):
    """GUI-control parity at the CLI: mono L+R mode with de-emphasis and a
    narrower cutoff produces a valid WAV whose two channels are identical."""
    wav = str(tmp_path / "mono.wav")
    out = run_cli(
        "demod", "-i", pcm_file, "-b", str(BLOCK), "-o", wav, "--no-rds",
        "--audio-mode", "lpr", "--deemphasis-us", "50",
        "--lpr-cutoff-hz", "12000",
    )
    assert out.returncode == 0, out.stderr.decode()
    audio, fs = read_wav_int16(wav)
    assert fs == 32000
    np.testing.assert_array_equal(audio[:, 0], audio[:, 1])


@pytest.mark.slow
def test_demod_crash_restart_with_periodic_checkpoint(pcm_file, tmp_path):
    """Periodic checkpointing + crash restart on the SAME file: interrupt a
    run (simulated by truncating the input), then resume with --resume-seek
    on the full file — the combined audio is bit-identical to one pass."""
    data = np.fromfile(pcm_file, np.uint8)
    n_blocks = len(data) // (2 * BLOCK)
    crash_at = n_blocks // 2
    trunc = tmp_path / "trunc.pcm"
    data[: crash_at * 2 * BLOCK].tofile(trunc)
    ckpt = tmp_path / "state.npz"

    w_full = tmp_path / "full.wav"
    r = run_cli("demod", "-i", pcm_file, "-b", str(BLOCK), "-o", str(w_full),
                "--no-rds")
    assert r.returncode == 0, r.stderr.decode()

    w1 = tmp_path / "before_crash.wav"
    r = run_cli("demod", "-i", str(trunc), "-b", str(BLOCK), "-o", str(w1),
                "--no-rds", "--save-state", str(ckpt), "--checkpoint-every", "2")
    assert r.returncode == 0, r.stderr.decode()
    assert f"block_index={crash_at}" in r.stderr.decode()

    w2 = tmp_path / "after_restart.wav"
    r = run_cli("demod", "-i", pcm_file, "-b", str(BLOCK), "-o", str(w2),
                "--no-rds", "--resume-state", str(ckpt), "--resume-seek")
    assert r.returncode == 0, r.stderr.decode()

    full, _ = read_wav_int16(str(w_full))
    a, _ = read_wav_int16(str(w1))
    b, _ = read_wav_int16(str(w2))
    np.testing.assert_array_equal(full, np.concatenate([a, b]))


def test_demod_output_rate_resample(pcm_file, tmp_path):
    """--rate 48000: output WAV resampled with the reference's linear
    interpolator (Resampled_PCM_Player)."""
    wav = str(tmp_path / "out48.wav")
    out = run_cli("demod", "-i", pcm_file, "-b", str(BLOCK), "-o", wav,
                  "--no-rds", "--rate", "48000")
    assert out.returncode == 0, out.stderr.decode()
    audio, fs = read_wav_int16(wav)
    assert fs == 48000
    assert abs(audio.shape[0] - BLOCK * 32 // 32 * 48000 // 32000) <= 2


@pytest.mark.slow
def test_scrape_stream_matches_batch(pcm_file, tmp_path):
    """--stream (native prefetching reader + incremental WAV sink) must
    produce byte-identical artifacts to the default batch path."""
    from fm_radio import runtime as rt

    if not rt.available():
        pytest.skip("native runtime not built")
    d1, d2 = tmp_path / "batch", tmp_path / "stream"
    r = run_cli("scrape", "-i", pcm_file, "-b", str(BLOCK), "-o", str(d1))
    assert r.returncode == 0, r.stderr.decode()
    r = run_cli("scrape", "-i", pcm_file, "-b", str(BLOCK), "-o", str(d2),
                "--stream")
    assert r.returncode == 0, r.stderr.decode()

    def artifacts(d):
        wav = [f for f in os.listdir(d) if f.endswith(".wav")][0]
        bin_ = [f for f in os.listdir(d) if f.endswith(".bin")][0]
        return (open(os.path.join(d, wav), "rb").read(),
                open(os.path.join(d, bin_), "rb").read())

    w1, b1 = artifacts(d1)
    w2, b2 = artifacts(d2)
    assert b1 == b2
    # WAV payloads identical; headers may differ only in chunk-size fields
    assert w1[44:] == w2[44:] and len(w1) == len(w2)


def test_synth_single_station_roundtrip(tmp_path):
    """`synth` -> `demod`: generated station must decode its PI, service
    name, RadioText and alternative-frequency list."""
    pcm = str(tmp_path / "syn.pcm")
    out = run_cli("synth", "-o", pcm, "--seconds", "1.0", "--pi", "0xABCD",
                  "--ps", "TESTFM  ", "--rt", "HELLO FROM JAX",
                  "--af", "87.6,90.3")
    assert out.returncode == 0, out.stderr.decode()
    info = json.loads(out.stdout.decode().strip())
    assert info["samples"] == 1_024_000 and info["rate"] == 1_024_000

    out = run_cli("demod", "-i", pcm, "-b", "32768",
                  "-o", str(tmp_path / "syn.wav"))
    assert out.returncode == 0, out.stderr.decode()
    db = json.loads(out.stdout.decode().strip().splitlines()[-1])
    assert db["pi_code"] == "ABCD"
    assert db["service_name"] == "TESTFM  "
    assert db["radio_text"] == "HELLO FROM JAX"
    assert db["alt_freqs_mhz"] == [87.6, 90.3]


@pytest.mark.slow
def test_synth_wideband_stations_roundtrip(tmp_path):
    """`synth --stations` -> `stations`: each station in the generated
    wideband capture decodes its own PI/name."""
    pcm = str(tmp_path / "wide.pcm")
    out = run_cli("synth", "-o", pcm, "--seconds", "1.0",
                  "--stations", "2", "-m", "4", "--pi", "0x3000")
    assert out.returncode == 0, out.stderr.decode()

    out = run_cli("stations", "-i", pcm, "-o", str(tmp_path / "st"),
                  "-m", "4", "-b", "32768", "--select", "1,2")
    assert out.returncode == 0, out.stderr.decode()
    text = out.stdout.decode()
    rows = json.loads(text[text.index("["):])
    assert [r["pi_code"] for r in rows] == ["3000", "3001"]
    assert [r["service_name"] for r in rows] == ["ST 01   ", "ST 02   "]


def test_synth_wideband_no_clipping(tmp_path):
    """>=3 stations summed must be normalized to the u8 grid (a fixed /2
    scale once clipped ~19% of samples into intermod products)."""
    pcm = str(tmp_path / "w4.pcm")
    out = run_cli("synth", "-o", pcm, "--seconds", "0.25",
                  "--stations", "4", "-m", "8")
    assert out.returncode == 0, out.stderr.decode()
    raw = np.fromfile(pcm, np.uint8)
    clipped = np.mean((raw == 0) | (raw == 255))
    assert clipped < 1e-4, f"{clipped:.2%} of samples clipped"


def test_selftest_passes():
    """`fmtpu selftest` — the headless install check (synth -> demod ->
    gates) must pass end-to-end on a clean checkout."""
    out = run_cli("selftest")
    assert out.returncode == 0, out.stderr.decode()
    text = out.stdout.decode()
    verdict = json.loads(text[text.index("{"):])
    assert verdict["pass"] is True
    assert verdict["checks"]["rds_service_name"]["value"] == "SELFTEST"
    assert verdict["checks"]["stereo_separation_db"]["value"] > 20.0


@pytest.mark.slow
def test_selftest_wideband():
    """`fmtpu selftest --stations 2` gates the channelize -> batched-demod
    pipeline: each station's PI + service name must decode."""
    out = run_cli("selftest", "--stations", "2")
    assert out.returncode == 0, out.stderr.decode()
    text = out.stdout.decode()
    verdict = json.loads(text[text.index("{"):])
    assert verdict["pass"] is True
    assert verdict["checks"]["station_2"]["pi"] == "1235"
