"""Card-only accuracy tests (skipped where JAX has no GPU backend).

They exist for a bug class CPU tests cannot catch: on a GPU the default
float32 matmul precision is TF32 (10-bit mantissa), while on the CPU it is
full f32, and the Pallas loop kernels run compiled by Triton rather than
through the interpreter.  The pilot peak filter's pole-power prep
(`ops/iir._power_stack`) once ran at default precision and detuned the
19 kHz resonator (~4 Hz bandwidth) on the accelerator only — costing
~50 dB of audio SNR while every CPU test stayed green.  Run on the card:

    FMTPU_GPU_TESTS=1 python -m pytest tests -m gpu -q

(``python chip_smoke.py`` runs them as its second phase.)
"""

import numpy as np
import pytest

import jax

pytestmark = pytest.mark.gpu


def test_power_stack_f64_parity():
    """Pole powers of the pilot peak resonator must match f64 to f32 grade
    on device (catches default-precision matmuls in coefficient prep)."""
    import jax.numpy as jnp

    from fm_radio.config import DemodConfig
    from fm_radio.models.demod import make_coeffs
    from fm_radio.ops.iir import _companion, _power_stack

    co = make_coeffs(DemodConfig())
    amat = _companion(jnp.asarray(co.peak_a))
    stack = np.asarray(jax.jit(lambda a: _power_stack(a, 128))(amat))

    a64 = np.asarray(amat, np.float64)
    p = np.eye(2)
    for j in range(129):
        err = np.abs(stack[j] - p).max()
        assert err < 1e-5, f"A^{j} err {err:.2e} (default-precision matmul?)"
        p = p @ a64


def test_pilot_theta_matches_highest():
    """The mid-end's pilot phase at the production FIR/IIR precision must
    track the same stages at Precision.HIGHEST to ~1e-4 cycles."""
    import jax.numpy as jnp

    from fm_radio.config import DemodConfig
    from fm_radio.models.demod import demod_init_state, make_coeffs
    from fm_radio.ops import fir, iir

    cfg = DemodConfig()
    co = make_coeffs(cfg)
    n = 32768
    t = np.arange(n) / 256000.0
    rng = np.random.default_rng(0)
    x = (0.2 * np.cos(2 * np.pi * 19000.0 * t)
         + 0.5 * np.cos(2 * np.pi * 1000.0 * t)
         + 0.01 * rng.standard_normal(n)).astype(np.float32)[None, :]
    st = demod_init_state(cfg, 1)

    def theta(x):
        _, fm_out = fir.polyphase_decimate(co.taps_fm_out, st["ds_fm_out"], x, 2)
        _, iq_o = fir.hilbert_fir_p(co.taps_hilbert, st["hilbert"], fm_out)
        _, pil = iir.iir_filter_planes(co.peak_b, co.peak_a, st["peak_pilot"],
                                       iq_o)
        return jnp.arctan2(pil[1], pil[0]) / (2 * np.pi)

    th_prod = np.asarray(jax.jit(theta)(jnp.asarray(x)))
    saved = fir.FIR_PRECISION, iir.IIR_PRECISION
    fir.FIR_PRECISION = iir.IIR_PRECISION = jax.lax.Precision.HIGHEST
    try:
        th_hi = np.asarray(jax.jit(theta)(jnp.asarray(x)))
    finally:
        fir.FIR_PRECISION, iir.IIR_PRECISION = saved
    d = th_prod - th_hi
    d -= np.round(d)
    rms = float(np.sqrt((d[:, 1024:] ** 2).mean()))
    assert rms < 1e-4, f"theta rms {rms:.2e} cycles vs HIGHEST"


def test_channelizer_matches_oracle_on_hardware():
    """The packed-ingest channelizer vs the scipy direct-downconversion
    oracle, on the card (its DFT products must stay full f32)."""
    import jax.numpy as jnp
    import scipy.signal as sig

    from fm_radio.parallel.channelizer import (
        channelize_packed,
        channelizer_init_state,
        make_channelizer_taps,
    )
    from fm_radio.utils.transfer import pack_iq_u8

    m, k = 8, 16
    n = 4096 * m
    rng = np.random.default_rng(11)
    iq_u8 = rng.integers(0, 256, size=(n, 2), dtype=np.uint8)
    w = jnp.asarray(pack_iq_u8(iq_u8))
    taps = make_channelizer_taps(m, k)
    st = channelizer_init_state(m, k)
    _, y = channelize_packed(taps, st, w, m)
    y = np.asarray(y)

    f = iq_u8.astype(np.float64) - 127.0
    x = f[:, 0] + 1j * f[:, 1]
    x_pad = np.concatenate([np.zeros((k - 1) * m), x])
    for ch in range(m):
        mixed = x_pad * np.exp(-2j * np.pi * ch * np.arange(len(x_pad)) / m)
        filt = sig.lfilter(taps.astype(np.float64), [1.0], mixed)
        ref = filt[m * np.arange(y.shape[1]) + m * k - 1]
        err = np.abs(y[ch] - ref).max()
        assert err < 2e-2, f"channel {ch}: max err {err:.2e}"


# one shape and config for the two demod_block tests below, so the card
# compiles the kernel path once
C_HW, N_HW = 128, 1 << 17


def _phase_walk_planes(seed):
    rng = np.random.default_rng(seed)
    ph = np.cumsum(0.5 * rng.standard_normal((C_HW, N_HW)), -1)
    u8 = np.stack([np.round(100 * np.cos(ph) + 127.0),
                   np.round(100 * np.sin(ph) + 127.0)], axis=-1)
    return u8.astype(np.uint8)


def test_i8_planes_match_f32_planes_on_hardware():
    """int8-plane ingest vs the same samples as f32 planes: the cast is
    exact, so the card's audio must be bit-identical."""
    import jax.numpy as jnp

    from fm_radio.config import DemodConfig
    from fm_radio.models.demod import demod_block, demod_init_state, make_coeffs
    from fm_radio.utils.transfer import split_iq_i8

    i8 = split_iq_i8(_phase_walk_planes(3))
    f32 = i8.astype(np.float32) + 1.0
    cfg = DemodConfig()
    co = make_coeffs(cfg)
    outs = [np.asarray(demod_block(cfg, co, demod_init_state(cfg, C_HW),
                                   jnp.asarray(x))[1]["audio"])
            for x in (i8, f32)]
    np.testing.assert_array_equal(outs[0], outs[1])


def test_kernel_path_matches_scan_path_on_hardware():
    """Full demod_block: the compiled Triton loop kernels vs the lax.scan
    loops, both on the card — catches miscompiles that interpret-mode CPU
    parity (test_kernels) cannot see."""
    import jax.numpy as jnp

    from fm_radio.config import DemodConfig
    from fm_radio.models.demod import (
        demod_block,
        demod_init_state,
        loop_kernels_enabled,
        make_coeffs,
    )

    u8 = _phase_walk_planes(0)
    x = jnp.asarray(np.moveaxis(u8, -1, 0).astype(np.float32) - 127.0)
    outs = {}
    for name, cfg in (("kernel", DemodConfig()),
                      ("scan", DemodConfig(loop_impl="scan"))):
        assert loop_kernels_enabled(cfg) is (name == "kernel")
        co = make_coeffs(cfg)
        _, o = demod_block(cfg, co, demod_init_state(cfg, C_HW), x)
        outs[name] = np.asarray(o["audio"])

    err = np.abs(outs["kernel"] - outs["scan"])
    # settle region: skip the first 2048 audio frames of loop acquisition
    assert err.shape[1] > 2048, "fixture too short: settle skip leaves nothing"
    rms = float(np.sqrt((err[:, 2048:] ** 2).mean()))
    sig_rms = float(np.sqrt((outs["scan"][:, 2048:] ** 2).mean()))
    snr = 20 * np.log10(sig_rms / (rms + 1e-12))
    assert snr > 45.0, f"kernel vs scan path only {snr:.1f} dB on the card"


def test_audio_precision_on_hardware():
    """Audio of stereo+RDS stations with the filter products at the
    production precision and at Precision.HIGH (TF32 on a GPU), each
    against the same chain at HIGHEST, all on the card.  Prints both SNRs
    (the precision decision in PERF.md); gates the production setting."""
    import jax.numpy as jnp

    from fm_radio.config import DemodConfig
    from fm_radio.io.pcm import c64_to_u8
    from fm_radio.io.synth import FMModulator, ModulatorConfig
    from fm_radio.models.demod import demod_block, demod_init_state, make_coeffs
    from fm_radio.ops import fir, iir
    from fm_radio.utils.transfer import split_iq_i8

    c, b, nb = 4, 1 << 16, 12
    x = np.stack([split_iq_i8(c64_to_u8(FMModulator(ModulatorConfig()).generate(
        b * nb, left_hz=700.0 + 100 * k, right_hz=2500.0,
        rds_groups=[(0x5000 + k, 1 << 10, 0xE101, 0x4141)]).astype(
            np.complex64))) for k in range(c)], axis=1)

    def audio(precision):
        saved = fir.FIR_PRECISION, iir.IIR_PRECISION
        fir.FIR_PRECISION = iir.IIR_PRECISION = precision
        try:
            jax.clear_caches()  # the precision is read at trace time
            cfg = DemodConfig(loop_impl="scan")
            co = make_coeffs(cfg)
            st = demod_init_state(cfg, c)
            out = []
            for i in range(nb):
                st, o = demod_block(cfg, co, st,
                                    jnp.asarray(x[:, :, i * b:(i + 1) * b]))
                out.append(np.asarray(o["audio"]))
            return np.concatenate(out, axis=1)[:, 8000:]
        finally:
            fir.FIR_PRECISION, iir.IIR_PRECISION = saved

    ref = audio(jax.lax.Precision.HIGHEST)

    def snr(a):
        return 10 * np.log10((ref**2).sum() / max(((a - ref)**2).sum(), 1e-30))

    snr_prod = snr(audio(fir.FIR_PRECISION))
    snr_tf32 = snr(audio(jax.lax.Precision.HIGH))
    print(f"[2] audio SNR vs HIGHEST on the card: production "
          f"({fir.FIR_PRECISION}) {snr_prod:.2f} dB, HIGH (TF32) "
          f"{snr_tf32:.2f} dB")
    assert snr_prod > 70.0, f"production precision {snr_prod:.2f} dB"


def test_wideband_bridge_golden_on_hardware():
    """A stereo+RDS station through the full device-resident wideband path
    (channelizer, i8 bridge, demod) at m=32: the audio is live and the PI
    decodes."""
    import jax.numpy as jnp

    from fm_radio.config import DemodConfig
    from fm_radio.io.pcm import c64_to_u8
    from fm_radio.io.synth import FMModulator, ModulatorConfig, make_wideband
    from fm_radio.models.demod import make_coeffs
    from fm_radio.models.wideband import wideband_demod_block, wideband_init_state
    from fm_radio.parallel.channelizer import make_channelizer_taps
    from fm_radio.rds.chain import RDSFullChain
    from fm_radio.utils.transfer import pack_iq_u8

    m, channel, b, n_blocks = 32, 3, 1 << 15, 24
    groups = [(0x5005, (0 << 12) | (1 << 10), 0xE101, 0x4242)]
    iq = FMModulator(ModulatorConfig()).generate(
        b * n_blocks, left_hz=1000.0, right_hz=3000.0, rds_groups=groups)
    wide = make_wideband({channel: iq}, m)
    wide *= 100.0 / np.abs(wide).max()
    words = pack_iq_u8(c64_to_u8(wide.astype(np.complex64)))

    cfg = DemodConfig()
    coeffs = make_coeffs(cfg)
    taps = make_channelizer_taps(m)
    st = wideband_init_state(cfg, m, 1)
    audio, pred, valid = [], [], []
    for blk in range(n_blocks):
        wb = jnp.asarray(words[blk * b * m : (blk + 1) * b * m])[None]
        st, o = wideband_demod_block(cfg, coeffs, taps, st, wb, m)
        audio.append(np.asarray(o["audio"])[channel])
        pred.append(np.asarray(o["rds_pred"])[channel])
        valid.append(np.asarray(o["rds_valid"])[channel])
    audio = np.concatenate(audio)
    tail = audio[audio.shape[0] // 4 :]
    assert np.isfinite(tail).all()
    assert float(np.sqrt((tail**2).mean())) > 1e-3
    chain = RDSFullChain()
    pred, valid = np.concatenate(pred), np.concatenate(valid)
    chain.process_symbols(pred[valid.astype(bool)])
    assert chain.db.pi_code == 0x5005, f"PI {chain.db.pi_code:04X}"
