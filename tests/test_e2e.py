"""End-to-end tests: software FM modulator -> full demod chain.

These are the hermetic equivalents of the reference's golden-recording
validation (SURVEY.md §4): assert pilot lock, mono/stereo audio recovery and
SNR, stereo separation, and RDS group round-trip — no off-air recordings
needed.
"""

import numpy as np
import pytest

from fm_radio.config import DemodConfig
from fm_radio.io.synth import FMModulator, ModulatorConfig
from fm_radio.models.app import App

BLOCK = 32768  # smaller than the default 65536 to keep CPU tests quick


def snr_db(sig: np.ndarray, ref: np.ndarray) -> float:
    err = sig - ref
    return 10 * np.log10(np.sum(ref**2) / (np.sum(err**2) + 1e-20))


def tone_power_ratio_db(x: np.ndarray, fs: float, f0: float, bw: float = 100.0):
    """Power near f0 vs total power (for separation checks)."""
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
    freqs = np.fft.rfftfreq(len(x), 1 / fs)
    band = (freqs > f0 - bw) & (freqs < f0 + bw)
    return 10 * np.log10(spec[band].sum() / spec.sum())


@pytest.fixture(scope="module")
def stereo_run():
    """One modulate->demodulate run shared by the audio assertions.

    L = 1 kHz, R = 3 kHz tones; RDS carries two alternating groups.
    """
    mod = FMModulator(ModulatorConfig())
    groups = [
        (0x1234, (0 << 12) | (1 << 10) | 0b00000, 0xE101, 0x4142),  # 0A
        (0x1234, (2 << 12) | 0b00000, 0x4845, 0x4C4C),              # 2A
    ]
    n = BLOCK * 24  # 0.75 s: TED/PLL lock plus margin for a false block-A
    # lock (3 burned groups) before real groups decode
    iq = mod.generate(
        n, left_hz=1000.0, right_hz=3000.0, rds_groups=groups
    )
    app = App(block_size=BLOCK, channels=1)
    app.process(iq)
    return app, groups


def test_pilot_lock_and_audio_recovery(stereo_run):
    app, _ = stereo_run
    audio = app.audio[0]  # [T, 2]
    fs_audio = app.demod.fs_audio
    # skip first 0.15 s (PLL + AGC settle)
    settle = int(0.15 * fs_audio)
    left, right = audio[settle:, 0], audio[settle:, 1]
    # L channel: 1 kHz dominates; R channel: 3 kHz dominates
    assert tone_power_ratio_db(left, fs_audio, 1000.0) > -3.0
    assert tone_power_ratio_db(right, fs_audio, 3000.0) > -3.0


def test_stereo_separation(stereo_run):
    app, _ = stereo_run
    audio = app.audio[0]
    fs_audio = app.demod.fs_audio
    settle = int(0.15 * fs_audio)
    left, right = audio[settle:, 0], audio[settle:, 1]
    # the 3 kHz (right) tone must be strongly suppressed in the left channel
    leak_l = tone_power_ratio_db(left, fs_audio, 3000.0)
    main_r = tone_power_ratio_db(right, fs_audio, 3000.0)
    separation = main_r - leak_l
    assert separation > 20.0, f"stereo separation only {separation:.1f} dB"


def test_audio_snr_vs_ideal(stereo_run):
    """Recovered left tone vs an ideally generated 1 kHz tone: fit amplitude
    and phase, require > 20 dB SNR (config 2 acceptance style)."""
    app, _ = stereo_run
    fs_audio = app.demod.fs_audio
    audio = app.audio[0]
    settle = int(0.2 * fs_audio)
    left = audio[settle:, 0].astype(np.float64)
    t = np.arange(len(left)) / fs_audio
    basis = np.stack([np.sin(2 * np.pi * 1000 * t), np.cos(2 * np.pi * 1000 * t)])
    coefs, *_ = np.linalg.lstsq(basis.T, left, rcond=None)
    fit = basis.T @ coefs
    assert snr_db(left, fit) > 20.0
    # expected amplitude: a_mono/2 (mono path) + a_stereo/2 (L-R path) = 0.45
    # (the x2 audio-mix gain only compensates the discriminator's x0.5)
    amp = np.hypot(*coefs)
    assert 0.3 < amp < 0.6


def test_rds_group_roundtrip(stereo_run):
    app, groups = stereo_run
    decoded = [
        tuple(blk.data for blk in g)
        for g in app.rds_chains[0].chain.groups
        if all(blk.is_valid for blk in g)
    ]
    # ~8.5 groups fit in 0.75 s at 11.4 groups/s minus TED/PLL lock time
    assert len(decoded) >= 2, f"only {len(decoded)} valid groups decoded"
    for g in groups:
        assert g in decoded, f"group {g} not recovered"
    db = app.rds_database(0)
    assert db.pi_code == 0x1234


def test_mono_path():
    """LPR-only output mode recovers the mono sum."""
    from dataclasses import replace

    mod = FMModulator(ModulatorConfig())
    n = BLOCK * 6
    iq = mod.generate(n, left_hz=800.0, right_hz=800.0)
    cfg = replace(DemodConfig(), audio_out="lpr")
    app = App(block_size=BLOCK, cfg=cfg, channels=1, decode_rds=False)
    app.process(iq)
    audio = app.audio[0]
    fs_audio = app.demod.fs_audio
    settle = int(0.1 * fs_audio)
    mono = audio[settle:, 0]
    assert tone_power_ratio_db(mono, fs_audio, 800.0) > -1.0
    # both channels identical in LPR mode
    np.testing.assert_array_equal(audio[:, 0], audio[:, 1])


def test_multichannel_batch_consistency():
    """Two channels fed the same IQ produce identical outputs (vmap-first
    design sanity)."""
    mod = FMModulator(ModulatorConfig())
    iq = mod.generate(BLOCK * 4, left_hz=1000.0, right_hz=2000.0)
    x = np.stack([iq, iq])
    app = App(block_size=BLOCK, channels=2, decode_rds=False)
    app.process(x)
    audio = app.audio
    np.testing.assert_allclose(audio[0], audio[1], atol=1e-5)


def test_input_chunking_invariance():
    """Feeding the stream in odd-sized chunks (through the reconstruction
    buffer, app.cpp:39-50) is bitwise identical to feeding it in one shot —
    blocking into block_size is the only thing that matters."""
    mod = FMModulator(ModulatorConfig())
    n = BLOCK * 4
    iq = mod.generate(n, left_hz=1000.0, right_hz=3000.0)

    app1 = App(block_size=BLOCK, channels=1, decode_rds=False)
    app1.process(iq)

    app2 = App(block_size=BLOCK, channels=1, decode_rds=False)
    pos, step = 0, 10007  # prime-sized chunks
    while pos < n:
        app2.process(iq[pos : pos + step])
        pos += step

    np.testing.assert_array_equal(app1.audio, app2.audio)


@pytest.mark.slow
def test_block_size_rds_robustness():
    """Audio depends (slightly) on block_size because AGC gains and the L-R
    phase offset update once per *block* — exactly like the reference
    (agc.h:6-31 updates per process() call).  The decoded RDS hard symbol
    decisions, however, must be identical."""
    import jax.numpy as jnp

    from fm_radio.models.demod import demod_block, demod_init_state, make_coeffs

    mod = FMModulator(ModulatorConfig())
    groups = [(0x1234, (0 << 12) | (1 << 10), 0xE101, 0x4142)]
    n = 8192 * 8
    iq = mod.generate(n, left_hz=1000.0, right_hz=3000.0, rds_groups=groups)[None, :]

    cfg = DemodConfig()
    coeffs = make_coeffs(cfg)

    def run(block):
        st = demod_init_state(cfg, 1)
        pred, valid = [], []
        for i in range(n // block):
            st, outs = demod_block(
                cfg, coeffs, st, jnp.asarray(iq[:, i * block : (i + 1) * block])
            )
            pred.append(np.asarray(outs["rds_pred"]))
            valid.append(np.asarray(outs["rds_valid"]))
        return np.concatenate(pred, axis=1), np.concatenate(valid, axis=1)

    p1, v1 = run(8192)
    p2, v2 = run(32768)
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(np.sign(p1[v1]), np.sign(p2[v2]))


@pytest.mark.slow
def test_plane_input_matches_complex_input():
    """demod_block([2, C, B] f32 planes) == demod_block([C, B] complex64)."""
    import jax.numpy as jnp

    from fm_radio.models.demod import demod_block, demod_init_state, make_coeffs

    mod = FMModulator(ModulatorConfig())
    iq = mod.generate(16384, left_hz=1000.0, right_hz=3000.0)[None, :]
    cfg = DemodConfig()
    coeffs = make_coeffs(cfg)

    st_c, outs_c = demod_block(cfg, coeffs, demod_init_state(cfg, 1), jnp.asarray(iq))
    planes = jnp.asarray(np.stack([iq.real, iq.imag]).astype(np.float32))
    st_p, outs_p = demod_block(cfg, coeffs, demod_init_state(cfg, 1), planes)

    np.testing.assert_array_equal(np.asarray(outs_c["audio"]), np.asarray(outs_p["audio"]))
    np.testing.assert_array_equal(np.asarray(outs_c["rds_pred"]), np.asarray(outs_p["rds_pred"]))


@pytest.mark.slow
def test_deemphasis_path():
    """De-emphasis IIR engages and attenuates high audio frequencies more
    than low ones (broadcast_fm_demod.cpp:403-406)."""
    from dataclasses import replace

    mod = FMModulator(ModulatorConfig())
    n = BLOCK * 6
    iq = mod.generate(n, left_hz=400.0, right_hz=8000.0)
    cfg = replace(DemodConfig(), use_deemphasis_filter=True, deemphasis_cutoff_us=50)
    app = App(block_size=BLOCK, cfg=cfg, channels=1, decode_rds=False)
    app.process(iq)
    audio = app.audio[0]
    fs_audio = app.demod.fs_audio
    settle = int(0.1 * fs_audio)

    app2 = App(block_size=BLOCK, channels=1, decode_rds=False)
    app2.process(iq)
    audio2 = app2.audio[0]

    def tone_amp(x, f0):
        spec = np.abs(np.fft.rfft(x * np.hanning(len(x))))
        freqs = np.fft.rfftfreq(len(x), 1 / fs_audio)
        return spec[np.argmin(np.abs(freqs - f0))]

    # 50 us de-emphasis (1-pole LPF at 1/(2*pi*50us) = 3.2 kHz; the
    # reference default Tus=1 is a no-op in the audio band) cuts 8 kHz much
    # more than 400 Hz relative to the flat chain
    lo_ratio = tone_amp(audio[settle:, 0], 400.0) / tone_amp(audio2[settle:, 0], 400.0)
    hi_ratio = tone_amp(audio[settle:, 1], 8000.0) / tone_amp(audio2[settle:, 1], 8000.0)
    assert hi_ratio < 0.5 * lo_ratio, (lo_ratio, hi_ratio)


@pytest.mark.slow
def test_process_all_matches_process():
    """App.process_all (one-dispatch lax.scan) == App.process (block loop),
    bitwise, including RDS chain state."""
    mod = FMModulator(ModulatorConfig())
    groups = [(0x1234, (0 << 12) | (1 << 10), 0xE101, 0x4142)]
    iq = mod.generate(BLOCK * 6 + 1234, left_hz=1000.0, right_hz=3000.0,
                      rds_groups=groups)  # non-multiple length: leaves a tail

    a1 = App(block_size=BLOCK, channels=1)
    a1.process(iq)
    a2 = App(block_size=BLOCK, channels=1)
    a2.process_all(iq)

    # audio: identical up to XLA fusion-order f32 rounding (~1e-7); the
    # RDS byte stream (hard decisions) must match exactly
    np.testing.assert_allclose(a1.audio, a2.audio, atol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(a1._pending), np.asarray(a2._pending)
    )
    assert a1.rds_bytes(0).tobytes() == a2.rds_bytes(0).tobytes()


@pytest.mark.slow
def test_app_i8_planes_ingest_matches_packed():
    """App fed [2, C, N] int8 planes (split_iq_i8) == App fed packed f32
    words, bitwise, through re-blocking (process) AND the one-dispatch scan
    (process_all): both decode to the same exact f32 samples.
    """
    from fm_radio.io.pcm import c64_to_u8
    from fm_radio.utils.transfer import pack_iq_u8, split_iq_i8

    mod = FMModulator(ModulatorConfig())
    groups = [(0x1234, (0 << 12) | (1 << 10), 0xE101, 0x4142)]
    iq = mod.generate(BLOCK * 4 + 999, left_hz=1000.0, right_hz=3000.0,
                      rds_groups=groups)  # non-multiple length: pending tail
    u8 = c64_to_u8(iq).reshape(-1, 2)
    w = pack_iq_u8(u8)                    # [N] f32 words
    i8 = split_iq_i8(u8)[:, None, :]      # [2, 1, N] int8 planes

    for batch in (False, True):
        a_pk = App(block_size=BLOCK, channels=1)
        a_i8 = App(block_size=BLOCK, channels=1)
        chunk = BLOCK + 4567  # misaligned chunks exercise re-blocking
        for off in range(0, len(w), chunk):
            feed = (a_pk.process_all if batch else a_pk.process)
            feed(w[off : off + chunk][None, :])
            feed = (a_i8.process_all if batch else a_i8.process)
            feed(i8[:, :, off : off + chunk])
        np.testing.assert_array_equal(a_pk.audio, a_i8.audio,
                                      err_msg=f"batch={batch}")
        assert a_pk.rds_bytes(0).tobytes() == a_i8.rds_bytes(0).tobytes()
        assert a_i8._pending.shape[-1] == a_pk._pending.shape[-1]


@pytest.mark.slow
def test_update_controls_midstream():
    """Runtime control changes (the reference's GUI dirty-flag redesign,
    broadcast_fm_demod.cpp:330-389): flip to LPR-only and enable de-emphasis
    mid-stream; the carried state survives and the change takes effect."""
    from fm_radio.models.demod import BroadcastFMDemod

    mod = FMModulator(ModulatorConfig())
    iq = mod.generate(BLOCK * 6, left_hz=1000.0, right_hz=3000.0)[None, :]

    d = BroadcastFMDemod(DemodConfig(), channels=1)
    out1 = d.process(iq[:, : BLOCK * 3])
    # stereo: L != R
    assert not np.array_equal(out1["audio"][..., 0], out1["audio"][..., 1])

    d.update_controls(audio_out="lpr", use_deemphasis_filter=True,
                      deemphasis_cutoff_us=50)
    out2 = d.process(iq[:, BLOCK * 3 :])
    # LPR: both channels identical from the switch on
    np.testing.assert_array_equal(out2["audio"][..., 0], out2["audio"][..., 1])

    import pytest
    with pytest.raises(ValueError):
        d.update_controls(order_fir_hilbert=129)  # orders are not mutable


def test_config_rejects_invalid_loop_impl():
    """An unknown loop implementation or chunk count fails at construction,
    not deep in demod_block."""
    import pytest

    from fm_radio.config import DemodConfig

    for bad in ("mosaic", "kernel", ""):
        with pytest.raises(ValueError, match="loop_impl"):
            DemodConfig(loop_impl=bad)
    with pytest.raises(ValueError, match="pll_time_chunks"):
        DemodConfig(pll_time_chunks=0)
    for ok in ("auto", "scan", "pallas"):
        DemodConfig(loop_impl=ok)


@pytest.mark.slow
def test_process_all_respects_runtime_controls():
    """`process_all` (the one-dispatch scan path) must honor controls applied
    via demod.update_controls — it once re-designed coefficients from a stale
    App-level config and silently diverged from `process`."""
    mod = FMModulator(ModulatorConfig())
    iq = mod.generate(BLOCK * 2, left_hz=1000.0, right_hz=3000.0)

    def run(batch: bool):
        app = App(block_size=BLOCK, channels=1, decode_rds=False)
        app.demod.update_controls(audio_out="lpr", use_deemphasis_filter=True)
        (app.process_all if batch else app.process)(iq)
        return app.audio[0]

    a, b = run(False), run(True)
    np.testing.assert_allclose(a, b, atol=1e-5)
    # LPR mode: both channels identical
    np.testing.assert_array_equal(a[:, 0], a[:, 1])


def test_modulator_streaming_matches_one_shot():
    """Two generate() calls must produce the identical IQ as one call of the
    combined length (phase- and RDS-symbol-continuity across blocks; the
    symbol stream was once sized per call and froze from block 2 on)."""
    groups = [(0x1234, 0, 0x0000, 0x4142)]
    n = 65536
    m1 = FMModulator(ModulatorConfig())
    one = m1.generate(2 * n, left_hz=700.0, right_hz=1900.0, rds_groups=groups)
    m2 = FMModulator(ModulatorConfig())
    a = m2.generate(n, left_hz=700.0, right_hz=1900.0, rds_groups=groups)
    b = m2.generate(n, left_hz=700.0, right_hz=1900.0, rds_groups=groups)
    np.testing.assert_allclose(
        np.concatenate([a, b]), one, atol=1e-3
    )


def test_noise_produces_no_false_rds_groups():
    """Receiver integrity on dead air: demodulating pure noise must yield
    finite audio and ZERO fully-valid RDS groups (a valid group needs four
    consecutive CRC-10 passes — random bits clear that at ~2^-40; anything
    decoded from noise would be a correction-logic bug)."""
    import numpy as np

    from fm_radio.models.app import App

    rng = np.random.default_rng(42)
    block = 16384
    n = block * 32  # 0.5 s
    iq = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64) * 40.0
    app = App(block_size=block, channels=1, decode_rds=True)
    app.process(iq)
    audio = app.audio[0]
    assert np.isfinite(audio).all()
    full = [g for g in app.rds_chains[0].chain.groups
            if all(b.is_valid for b in g)]
    assert not full, f"decoded {len(full)} groups from noise"
