"""Wideband channelize->demod composition (models/wideband.py) and the
batched-capture filterbank (channelize_batch_p).

The stations-from-wideband path is one jittable device-resident step;
these tests pin its correctness on CPU — batch==single exactness, the i8
bridge's scale and its end-to-end accuracy."""

import jax.numpy as jnp
import numpy as np
import pytest

from fm_radio.parallel.channelizer import (
    _channelize_xla_p,
    channelize_batch_p,
    make_channelizer_taps,
)
from fm_radio.utils.transfer import pack_iq_u8


def _rand_planes(rng, shape):
    return (rng.standard_normal(shape).astype(np.float32) * 50.0,
            rng.standard_normal(shape).astype(np.float32) * 50.0)


def test_channelize_batch_matches_single():
    """Batched captures == per-capture loop, exactly, across streamed
    blocks (tail carry per capture)."""
    m, k, w, t = 8, 4, 3, 1024
    taps = jnp.asarray(make_channelizer_taps(m, k))
    rng = np.random.default_rng(0)
    xr, xi = _rand_planes(rng, (w, 2 * t))

    st_b = (jnp.zeros((w, (k - 1) * m)), jnp.zeros((w, (k - 1) * m)))
    outs_b = []
    for blk in range(2):
        sl = slice(blk * t, (blk + 1) * t)
        st_b, y = channelize_batch_p(
            taps, st_b, (jnp.asarray(xr[:, sl]), jnp.asarray(xi[:, sl])), m)
        outs_b.append(np.stack([np.asarray(y[0]), np.asarray(y[1])]))

    for wi in range(w):
        st = (jnp.zeros(((k - 1) * m,)), jnp.zeros(((k - 1) * m,)))
        for blk in range(2):
            sl = slice(blk * t, (blk + 1) * t)
            st, y = _channelize_xla_p(
                taps, st, (jnp.asarray(xr[wi, sl]), jnp.asarray(xi[wi, sl])), m)
            np.testing.assert_array_equal(
                outs_b[blk][0, wi], np.asarray(y[0]))
            np.testing.assert_array_equal(
                outs_b[blk][1, wi], np.asarray(y[1]))




def _station_wideband(m: int, n_ch: int, channel: int):
    from fm_radio.io.synth import FMModulator, ModulatorConfig, make_wideband

    mod = FMModulator(ModulatorConfig())
    groups = [(0xBEEF, (0 << 12) | (1 << 10), 0xE101, 0x5A5A)]
    iq = mod.generate(n_ch, left_hz=800.0, right_hz=1600.0, rds_groups=groups)
    wide = make_wideband({channel: iq}, m)
    wide *= 100.0 / np.abs(wide).max()
    # the capture's native u8 quantization (app.cpp:57-63)
    u8 = np.stack([np.round(wide.real + 127.0),
                   np.round(wide.imag + 127.0)], axis=-1)
    return np.clip(u8, 0, 255).astype(np.uint8)


def test_wideband_demod_block_bridges():
    """End-to-end: one real station in an m=8 grid through
    wideband_demod_block; the i8 bridge (re-quantize channel planes to the
    u8 grid, 2 bytes per sample into the demod) must cost ~nothing vs
    the exact f32 bridge — the capture was ALREADY u8-quantized, so the
    bridge adds a second quantization at the same grid."""
    from fm_radio.config import DemodConfig
    from fm_radio.models.demod import make_coeffs
    from fm_radio.models.wideband import (
        wideband_demod_block,
        wideband_init_state,
    )

    m, channel = 8, 2
    b = 1 << 15  # per-channel block
    u8 = _station_wideband(m, b, channel)
    w_words = jnp.asarray(pack_iq_u8(u8))[None]  # W=1 capture

    outs = {}
    cfg = DemodConfig()
    coeffs = make_coeffs(cfg)
    for bridge in ("f32", "i8"):
        st = wideband_init_state(cfg, m, n_captures=1)
        st, o = wideband_demod_block(cfg, coeffs, None, st, w_words, m,
                                     bridge=bridge)
        outs[bridge] = np.asarray(o["audio"])

    # settle: skip the first quarter (filter fills + PLL acquisition)
    n = outs["f32"].shape[1]
    a, bq = outs["f32"][channel, n // 4:], outs["i8"][channel, n // 4:]
    err = a - bq
    snr = 10.0 * np.log10(float((a**2).sum()) / max(float((err**2).sum()),
                                                    1e-30))
    assert snr > 35.0, f"i8 bridge costs too much: {snr:.1f} dB"
    # and the audio itself is a real stereo signal (tones recovered)
    rms = float(np.sqrt((bq**2).mean()))
    assert rms > 1e-3


@pytest.mark.slow
def test_wideband_short_prototype_rejected():
    """Measured rejection record (round 5): taps_per_phase=8 (the cheap
    prototype, ~40% fewer filterbank products at m=32) leaks an OCCUPIED
    adjacent channel badly — 8.4 dB audio agreement vs the K=16 prototype
    (K=12: 11.9 dB).  K=16 stays the quality default.  This test pins
    the finding so the lever is not re-derived: the short prototype must
    measurably DIVERGE (if it ever stops diverging, the lens is safe to
    adopt — re-measure)."""
    from fm_radio.config import DemodConfig
    from fm_radio.io.synth import FMModulator, ModulatorConfig, make_wideband
    from fm_radio.models.demod import make_coeffs
    from fm_radio.models.wideband import (
        wideband_demod_block,
        wideband_init_state,
    )
    from fm_radio.parallel.channelizer import make_channelizer_taps

    m, b = 8, 1 << 15
    mod = FMModulator(ModulatorConfig())
    iq2 = mod.generate(b, left_hz=800.0, right_hz=1600.0,
                   rds_groups=[(0xBEEF, 1 << 10, 0xE101, 0x5A5A)])
    mod2 = FMModulator(ModulatorConfig())
    iq3 = mod2.generate(b, left_hz=500.0, right_hz=2500.0,
                    rds_groups=[(0xCAFE, 1 << 10, 0xE101, 0x1234)])
    wide = make_wideband({2: iq2, 3: iq3}, m)
    wide *= 110.0 / np.abs(wide).max()
    u8 = np.clip(np.stack([np.round(wide.real + 127.0),
                           np.round(wide.imag + 127.0)], axis=-1),
                 0, 255).astype(np.uint8)
    w_words = jnp.asarray(pack_iq_u8(u8))[None]

    cfg = DemodConfig()
    coeffs = make_coeffs(cfg)
    audio = {}
    for kk in (16, 8):
        taps = make_channelizer_taps(m, kk)
        st = wideband_init_state(cfg, m, 1, taps_per_phase=kk)
        st, o = wideband_demod_block(cfg, coeffs, taps, st, w_words, m,
                                     bridge="i8")
        audio[kk] = np.asarray(o["audio"])[2]

    n = audio[16].shape[0]
    a16, a8 = audio[16][n // 4 :], audio[8][n // 4 :]
    err = a16 - a8
    snr = 10.0 * np.log10(float((a16**2).sum())
                          / max(float((err**2).sum()), 1e-30))
    # the K16 path itself must carry a real signal...
    assert float(np.sqrt((a16**2).mean())) > 1e-3
    # ...and K=8 must still show the measured divergence that rejected it
    assert snr < 18.0, (
        f"K=8 now agrees at {snr:.1f} dB — the cheap-prototype lens may "
        "have become safe; re-measure before adopting")


def test_wideband_demod_block_default_taps():
    """ch_taps=None uses make_channelizer_taps; W=2 captures fill C=2M
    demod channels and the station lands on the right global row."""
    from fm_radio.config import DemodConfig
    from fm_radio.models.demod import make_coeffs
    from fm_radio.models.wideband import (
        wideband_demod_block,
        wideband_init_state,
    )

    m, channel = 8, 1
    b = 1 << 13
    u8 = _station_wideband(m, b, channel)
    w1 = pack_iq_u8(u8)
    # capture 0: silence; capture 1: the station
    w_words = jnp.asarray(np.stack([np.full_like(w1, 127.0 * 256 + 127.0),
                                    w1]))
    cfg = DemodConfig()
    coeffs = make_coeffs(cfg)
    st = wideband_init_state(cfg, m, n_captures=2)
    st, o = wideband_demod_block(cfg, coeffs, None, st, w_words, m,
                                 bridge="i8")
    audio = np.asarray(o["audio"])
    assert audio.shape[0] == 2 * m
    row = m + channel  # capture 1, channel 1
    tail = audio[:, audio.shape[1] // 2:]
    rms = np.sqrt((tail**2).mean(axis=(1, 2)))
    assert rms[row] > 5 * rms[:m].max() + 1e-9


def test_i8_bridge_keeps_capture_scale():
    """The filterbank has unit passband gain, so the i8 bridge quantizes
    each channel at the capture's own u8 scale: two stations sharing one
    capture each keep ~half its amplitude, and the int8 planes equal the
    f32 planes to within the rounding step."""
    from fm_radio.io.synth import FMModulator, ModulatorConfig, make_wideband

    m, n = 8, 1 << 12
    iq = {ch: FMModulator(ModulatorConfig()).generate(n, left_hz=700.0 * ch)
          for ch in (1, 5)}
    wide = make_wideband(iq, m)
    wide *= 100.0 / np.abs(wide).max()
    u8 = np.clip(np.stack([np.round(wide.real + 127.0),
                           np.round(wide.imag + 127.0)], axis=-1),
                 0, 255).astype(np.uint8)
    words = jnp.asarray(pack_iq_u8(u8))[None]
    taps = make_channelizer_taps(m)
    z = jnp.zeros((1, 15 * m))
    _, (yr, yi) = channelize_batch_p(taps, (z, z), words, m)
    _, y8 = channelize_batch_p(taps, (z, z), words, m, out="i8")
    for ch in (1, 5):
        f = np.asarray(yr[0, ch]) + 1j * np.asarray(yi[0, ch])
        q = (np.asarray(y8[0, 0, ch], np.float32) + 1.0
             + 1j * (np.asarray(y8[1, 0, ch], np.float32) + 1.0))
        settled = slice(32, None)
        assert 30.0 < np.abs(f[settled]).mean() < 70.0
        assert np.abs(q - f)[settled].max() <= 0.5 * np.sqrt(2) + 1e-4
