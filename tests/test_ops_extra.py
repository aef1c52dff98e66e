"""Tests for the remaining DSP surface: polyphase upsampler, FFT Hilbert,
delay line, spectra."""

import numpy as np
import jax.numpy as jnp
import scipy.signal as sig

from fm_radio.ops.design import create_fir_lpf
from fm_radio.ops.fir import polyphase_upsample, polyphase_upsample_init_state
from fm_radio.ops.hilbert_fft import delay_line, hilbert_fft
from fm_radio.ops.spectrum import fft_mag_db, fft_mag_update

RNG = np.random.default_rng(21)


def test_polyphase_upsample_matches_zero_stuffed_conv():
    l, k = 4, 8
    taps = create_fir_lpf(l * k, 0.9 / l)
    x = RNG.standard_normal((1, 64)).astype(np.float32)
    st = polyphase_upsample_init_state(1, k)
    _, y = polyphase_upsample(taps, st, jnp.asarray(x), l)
    y = np.asarray(y)[0]

    # oracle: L * conv(zero_stuffed(x), h), causal with K-1 input history
    # (PolyphaseUpsampler semantics, polyphase_filter.h:90-185)
    x_ext = np.concatenate([np.zeros(k - 1, np.float32), x[0]])
    z = np.zeros(len(x_ext) * l, np.float32)
    z[::l] = x_ext
    full = sig.lfilter(taps.astype(np.float64) * l, [1.0], z)
    # y[i*L + p] corresponds to x index i with K-1 history: the window for
    # output (i, p) ends at zero-stuffed position ((k-1) + i)*L + p
    ref = full[(k - 1) * l : (k - 1) * l + len(y)]
    np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-5)


def test_polyphase_upsample_streaming():
    l, k = 4, 8
    taps = create_fir_lpf(l * k, 0.9 / l)
    x = RNG.standard_normal((2, 128)).astype(np.float32)
    st = polyphase_upsample_init_state(2, k)
    _, y_full = polyphase_upsample(taps, st, jnp.asarray(x), l)
    st = polyphase_upsample_init_state(2, k)
    parts = []
    for blk in np.split(x, 4, axis=1):
        st, y = polyphase_upsample(taps, st, jnp.asarray(blk), l)
        parts.append(np.asarray(y))
    np.testing.assert_allclose(
        np.asarray(y_full), np.concatenate(parts, axis=1), atol=1e-5
    )


def test_hilbert_fft_matches_scipy():
    x = RNG.standard_normal((2, 256)).astype(np.float32)
    y = np.asarray(hilbert_fft(jnp.asarray(x)))
    ref = sig.hilbert(x, axis=-1)
    np.testing.assert_allclose(y, ref, rtol=1e-3, atol=1e-4)


def test_delay_line():
    k = 5
    x = RNG.standard_normal((1, 20)).astype(np.float32)
    st = jnp.zeros((1, k), jnp.float32)
    st, y = delay_line(st, jnp.asarray(x[:, :10]))
    st, y2 = delay_line(st, jnp.asarray(x[:, 10:]))
    got = np.concatenate([np.asarray(y), np.asarray(y2)], axis=1)
    expect = np.concatenate([np.zeros((1, k), np.float32), x[:, :-k]], axis=1)
    np.testing.assert_array_equal(got, expect)


def test_fft_mag_modes():
    x = (RNG.standard_normal((1, 64)) + 1j * RNG.standard_normal((1, 64))).astype(
        np.complex64
    )
    m0 = fft_mag_db(jnp.asarray(x))
    assert m0.shape == (1, 64)
    avg = fft_mag_update(None, jnp.asarray(x))
    avg2 = fft_mag_update(avg, jnp.asarray(x * 2), mode="average", beta=0.5)
    hold = fft_mag_update(avg, jnp.asarray(x * 2), mode="max_hold")
    assert np.all(np.asarray(hold) >= np.asarray(avg) - 1e-5)
    assert np.all(np.asarray(avg2) >= np.asarray(avg) - 1e-5)


def test_spectrum_view_triggers():
    from fm_radio.ops.spectrum import (
        MODE_MAX_HOLD,
        TRIGGER_SINGLE,
        SpectrumView,
        fft_mag_db,
    )

    x1 = np.exp(2j * np.pi * 0.1 * np.arange(64)).astype(np.complex64)
    x2 = np.exp(2j * np.pi * 0.2 * np.arange(64)).astype(np.complex64)

    # SINGLE: first update lands, further ones ignored until re-armed
    v = SpectrumView(mode="normal", trigger=TRIGGER_SINGLE)
    v.update(jnp.asarray(x1))
    first = np.asarray(v.buffer).copy()
    v.update(jnp.asarray(x2))
    np.testing.assert_array_equal(np.asarray(v.buffer), first)
    v.arm()
    v.update(jnp.asarray(x2))
    assert not np.array_equal(np.asarray(v.buffer), first)

    # MAX_HOLD keeps the envelope of both tones
    m = SpectrumView(mode=MODE_MAX_HOLD)
    m.update(jnp.asarray(x1))
    m.update(jnp.asarray(x2))
    env = np.asarray(m.buffer)
    for x in (x1, x2):
        assert env.max() >= np.asarray(fft_mag_db(jnp.asarray(x))).max() - 1e-3


def test_polyphase_upsample_streaming_single_tap_phase():
    """Degenerate taps_per_phase==1 (len(taps)==factor): the carried state
    must stay EMPTY — a `-0:` slice once returned the whole block and
    duplicated output on the next call."""
    l = 4
    taps = np.full(l, 1.0 / l, np.float32)  # K=1 per phase
    x = RNG.standard_normal((2, 64)).astype(np.float32)
    st = polyphase_upsample_init_state(2, 1)
    st1, y_full = polyphase_upsample(taps, st, jnp.asarray(x), l)
    assert st1.shape[-1] == 0
    st = polyphase_upsample_init_state(2, 1)
    parts = []
    for blk in np.split(x, 2, axis=1):
        st, y = polyphase_upsample(taps, st, jnp.asarray(blk), l)
        parts.append(np.asarray(y))
    got = np.concatenate(parts, axis=1)
    assert got.shape == np.asarray(y_full).shape
    np.testing.assert_allclose(np.asarray(y_full), got, atol=1e-6)


def test_delay_line_zero_delay():
    """K==0 must be the identity with an empty carried state (a `-0:` slice
    once grew the state by a block per call)."""
    x = RNG.standard_normal((1, 16)).astype(np.float32)
    st = jnp.zeros((1, 0), jnp.float32)
    st, y1 = delay_line(st, jnp.asarray(x[:, :8]))
    assert st.shape[-1] == 0
    st, y2 = delay_line(st, jnp.asarray(x[:, 8:]))
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(y1), np.asarray(y2)], axis=1), x
    )


def test_fir_designers_reject_single_tap():
    import pytest

    from fm_radio.ops.design import create_fir_bpf, create_fir_hpf

    for fn, args in ((create_fir_lpf, (1, 0.5)), (create_fir_hpf, (1, 0.5)),
                     (create_fir_bpf, (1, 0.2, 0.5))):
        with pytest.raises(AssertionError):
            fn(*args)
