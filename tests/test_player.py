"""Real-time audio output parity (``io/player.py`` vs ``src/audio/``):
per-buffer linear resampling (Resampled_PCM_Player), mixer gain law
(AudioMixer), PortAudio f32 stream format, pipe-as-device sink."""

import io
import os
import subprocess
import sys

import numpy as np

from fm_radio.io.player import PCMPlayer
from fm_radio.ops.resample import linear_resample

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(11)


def test_player_resamples_per_buffer_like_reference():
    """Each consumed buffer is resampled independently with M = int(L*N)
    (resampled_pcm_player.cpp:22-26) — no cross-buffer phase carry, because
    the reference carries none."""
    sink = io.BytesIO()
    p = PCMPlayer(fileobj=sink, output_rate=48000)
    blocks = [(RNG.standard_normal((2048, 2)) * 0.3).astype(np.float32)
              for _ in range(3)]
    for b in blocks:
        p.consume(b, 32000)
    p.close()

    expect = np.concatenate(
        [np.asarray(linear_resample(b, int(48000 / 32000 * len(b))))
         for b in blocks])
    got = np.frombuffer(sink.getvalue(), "<f4").reshape(-1, 2)
    np.testing.assert_allclose(got, np.clip(expect, -1, 1), atol=1e-6)
    assert p.frames_written == 3 * 3072


def test_player_native_rate_passthrough_and_s16():
    sink = io.BytesIO()
    p = PCMPlayer(fileobj=sink, output_rate=32000, fmt="s16")
    b = (RNG.standard_normal((1000, 2)) * 0.2).astype(np.float32)
    p.consume(b, 32000)
    p.close()
    from fm_radio.io.wav import float_to_int16

    got = np.frombuffer(sink.getvalue(), "<i2").reshape(-1, 2)
    np.testing.assert_array_equal(got, float_to_int16(b))


def test_player_mixer_gain_law():
    """gain / log10(10 * n_sources) with clamp (audio_mixer.cpp:61-80)."""
    b = np.full((64, 2), 0.5, np.float32)
    for n, gain in ((1, 1.0), (4, 2.0)):
        sink = io.BytesIO()
        p = PCMPlayer(fileobj=sink, output_rate=32000, gain=gain, n_sources=n)
        p.consume(b, 32000)
        got = np.frombuffer(sink.getvalue(), "<f4")
        expect = np.clip(0.5 * gain / np.log10(10.0 * n), -1, 1)
        np.testing.assert_allclose(got, expect, rtol=1e-6)


def test_player_pipes_to_command_with_backpressure():
    """The sink process IS the audio device: a slow consumer's full pipe
    blocks consume() (RingBuffer::ConsumeBuffer back-pressure parity) and
    everything written arrives."""
    out = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                       f"player_{os.getpid()}.pcm")
    try:
        p = PCMPlayer(command=f"cat > {out}", output_rate=48000)
        total = 0
        for _ in range(8):
            total += p.consume(
                (RNG.standard_normal((2048, 2)) * 0.1).astype(np.float32),
                32000)
        rc = p.close()
        assert rc == 0
        assert os.path.getsize(out) == total * 2 * 4
    finally:
        if os.path.exists(out):
            os.remove(out)


def test_demod_play_cli_end_to_end(tmp_path):
    """`fmtpu demod --play` plays a 48 kHz stream whose tone survives the
    resample — the PortAudio-parity user surface."""
    from fm_radio.io.pcm import c64_to_u8
    from fm_radio.io.synth import FMModulator, ModulatorConfig

    block = 16384
    mod = FMModulator(ModulatorConfig())
    iq = mod.generate(block * 16, left_hz=1000.0, right_hz=1000.0)
    pcm = tmp_path / "in.pcm"
    c64_to_u8(iq).tofile(pcm)
    out = tmp_path / "out.f32"

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    r = subprocess.run(
        [sys.executable, "-m", "fm_radio.apps.cli", "demod",
         "-i", str(pcm), "-b", str(block), "--no-rds",
         "--play", f"cat > {out}"],
        capture_output=True, env=env, timeout=600, cwd=REPO,
    )
    assert r.returncode == 0, r.stderr.decode()[-1500:]
    audio = np.frombuffer(out.read_bytes(), "<f4").reshape(-1, 2)
    # 16 blocks * (16384/32 = 512) frames at 32k -> x1.5 at 48k
    assert audio.shape[0] == 16 * 512 * 3 // 2
    settled = audio[audio.shape[0] // 2:, 0]
    spec = np.abs(np.fft.rfft(settled * np.hanning(settled.size)))
    freqs = np.fft.rfftfreq(settled.size, 1 / 48000.0)
    peak = freqs[np.argmax(spec)]
    assert abs(peak - 1000.0) < 20.0, peak


def test_player_sink_death_raises_clean_error():
    """A sink that never starts (sh exit 127) or dies mid-stream must raise
    PlayerSinkError from consume(), not a raw BrokenPipeError traceback."""
    import pytest

    from fm_radio.io.player import PlayerSinkError

    p = PCMPlayer(command="no_such_audio_binary_xyz", output_rate=32000)
    b = np.zeros((4096, 2), np.float32)
    with pytest.raises(PlayerSinkError):
        for _ in range(200):  # pipe buffer absorbs the first writes
            p.consume(b, 32000)
    p.close()


def test_player_close_reports_sink_exit_code():
    p = PCMPlayer(command="cat > /dev/null; exit 3", output_rate=32000)
    p.consume(np.zeros((16, 2), np.float32), 32000)
    assert p.close() == 3
