"""Op-level unit tests vs NumPy/SciPy oracles, including streaming (block
boundary) parity — the property the reference implements with carried ``xn``
histories (fir_filter.h:14, polyphase_filter.h:17)."""

import numpy as np
import jax.numpy as jnp
import scipy.signal as sig

from fm_radio.ops import (
    agc_init_state,
    agc_process,
    apply_harmonic_pll,
    chebyshev_sine,
    create_fir_lpf,
    create_iir_peak_1_filter,
    create_iir_single_pole_lpf,
    fir_filter,
    fir_init_state,
    fm_discriminate,
    hilbert_fir,
    hilbert_init_state,
    polyphase_decimate,
    polyphase_init_state,
)
from fm_radio.ops import create_fir_hilbert
from fm_radio.ops.iir import iir_filter, iir_init_state, iir_filter_complex

RNG = np.random.default_rng(0)


def _stream(f, state, x, nblk):
    """Run f over x split into nblk blocks, concatenating outputs."""
    outs = []
    for blk in np.split(x, nblk, axis=-1):
        state, y = f(state, jnp.asarray(blk))
        outs.append(np.asarray(y))
    return np.concatenate(outs, axis=-1)


# ---------------------------------------------------------------- FIR / poly


def test_fir_matches_scipy_zero_state():
    taps = create_fir_lpf(33, 0.3)
    x = RNG.standard_normal((2, 256)).astype(np.float32)
    _, y = fir_filter(taps, fir_init_state(2, 33), jnp.asarray(x))
    ref = sig.lfilter(taps, [1.0], x, axis=-1)
    np.testing.assert_allclose(np.asarray(y), ref, rtol=1e-4, atol=1e-5)


def test_fir_streaming_equals_single_shot():
    taps = create_fir_lpf(65, 0.2)
    x = RNG.standard_normal((3, 512)).astype(np.float32)
    _, y1 = fir_filter(taps, fir_init_state(3, 65), jnp.asarray(x))
    y2 = _stream(
        lambda s, b: fir_filter(taps, s, b), fir_init_state(3, 65), x, 8
    )
    np.testing.assert_allclose(np.asarray(y1), y2, rtol=1e-5, atol=1e-6)


def test_polyphase_matches_decimated_convolution():
    m, k = 4, 16
    taps = create_fir_lpf(m * k, 0.95 / m)
    x = RNG.standard_normal((2, 64 * m)).astype(np.float32)
    _, y = polyphase_decimate(taps, polyphase_init_state(2, m, k), jnp.asarray(x), m)
    # oracle: full convolution then take outputs at window-end (i+1)*m-1
    full = sig.lfilter(taps, [1.0], x, axis=-1)
    ref = full[:, m - 1 :: m]
    np.testing.assert_allclose(np.asarray(y), ref, rtol=1e-4, atol=1e-5)


def test_polyphase_complex_streaming():
    m, k = 8, 16
    taps = create_fir_lpf(m * k, 0.9 / m)
    x = (
        RNG.standard_normal((2, 128 * m)) + 1j * RNG.standard_normal((2, 128 * m))
    ).astype(np.complex64)
    st0 = polyphase_init_state(2, m, k, dtype=jnp.complex64)
    _, y1 = polyphase_decimate(taps, st0, jnp.asarray(x), m)
    y2 = _stream(
        lambda s, b: polyphase_decimate(taps, s, b, m), st0, x, 4
    )
    np.testing.assert_allclose(np.asarray(y1), y2, rtol=1e-4, atol=1e-5)
    full = sig.lfilter(taps, [1.0], x, axis=-1)
    ref = full[:, m - 1 :: m]
    np.testing.assert_allclose(np.asarray(y1), ref, rtol=1e-3, atol=1e-4)


def test_hilbert_analytic_signal():
    taps = create_fir_hilbert(65)
    n = 4096
    t = np.arange(n)
    x = np.cos(2 * np.pi * 0.1 * t).astype(np.float32)[None, :]
    _, y = hilbert_fir(taps, hilbert_init_state(1, 65), jnp.asarray(x))
    y = np.asarray(y)[0]
    # steady state: analytic signal of cos = exp(j w t) (delayed by 32)
    seg = y[200:-200]
    np.testing.assert_allclose(np.abs(seg), 1.0, atol=0.02)
    # instantaneous frequency = 0.1 cycles/sample
    dphi = np.angle(seg[1:] * np.conj(seg[:-1])) / (2 * np.pi)
    np.testing.assert_allclose(dphi, 0.1, atol=2e-3)  # unwindowed-taps ripple


def test_hilbert_streaming():
    taps = create_fir_hilbert(65)
    x = RNG.standard_normal((2, 512)).astype(np.float32)
    _, y1 = hilbert_fir(taps, hilbert_init_state(2, 65), jnp.asarray(x))
    y2 = _stream(lambda s, b: hilbert_fir(taps, s, b), hilbert_init_state(2, 65), x, 8)
    np.testing.assert_allclose(np.asarray(y1), y2, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------- IIR


def test_iir_assoc_matches_scipy_order1():
    b, a = create_iir_single_pole_lpf(0.1)
    x = RNG.standard_normal((2, 300)).astype(np.float32)
    _, y = iir_filter(b, a, iir_init_state(2, 1), jnp.asarray(x))
    ref = sig.lfilter(b, a, x, axis=-1)
    np.testing.assert_allclose(np.asarray(y), ref, rtol=1e-3, atol=1e-4)


def test_iir_assoc_matches_scan_order2():
    b, a = create_iir_peak_1_filter(19000 / 64000, 0.9999)
    x = RNG.standard_normal((1, 2048)).astype(np.float32)
    st = iir_init_state(1, 2)
    _, y_assoc = iir_filter(b, a, st, jnp.asarray(x), method="assoc")
    _, y_scan = iir_filter(b, a, st, jnp.asarray(x), method="scan")
    np.testing.assert_allclose(
        np.asarray(y_assoc), np.asarray(y_scan), rtol=1e-3, atol=1e-3
    )


def test_iir_toeplitz_matches_scan_order2():
    b, a = create_iir_peak_1_filter(19000 / 64000, 0.9999)
    # double precision oracle to separate method error from f32 rounding
    x = RNG.standard_normal((2, 2048)).astype(np.float32)
    st = iir_init_state(2, 2)
    _, y_toep = iir_filter(b, a, st, jnp.asarray(x), method="toeplitz")
    _, y_scan = iir_filter(b, a, st, jnp.asarray(x), method="scan")
    np.testing.assert_allclose(
        np.asarray(y_toep), np.asarray(y_scan), rtol=1e-3, atol=1e-3
    )


def test_iir_toeplitz_streaming_non_multiple_block():
    # block length not a multiple of the internal chunk, nonzero entry state
    b, a = create_iir_peak_1_filter(0.3, 0.995)
    x = RNG.standard_normal((2, 700)).astype(np.float32)
    _, y1 = iir_filter(b, a, iir_init_state(2, 2), jnp.asarray(x), method="toeplitz")
    y2 = _stream(
        lambda s, blk: iir_filter(b, a, s, blk, method="toeplitz"),
        iir_init_state(2, 2),
        x,
        5,  # 140-sample blocks: exercises padding + carried y_hist
    )
    np.testing.assert_allclose(np.asarray(y1), y2, rtol=1e-3, atol=1e-4)
    ref = sig.lfilter(b, a, x, axis=-1)
    np.testing.assert_allclose(y2, ref, rtol=1e-2, atol=1e-3)


def test_iir_streaming_order2():
    b, a = create_iir_peak_1_filter(0.3, 0.995)
    x = RNG.standard_normal((2, 400)).astype(np.float32)
    _, y1 = iir_filter(b, a, iir_init_state(2, 2), jnp.asarray(x))
    y2 = _stream(
        lambda s, blk: iir_filter(b, a, s, blk), iir_init_state(2, 2), x, 4
    )
    np.testing.assert_allclose(np.asarray(y1), y2, rtol=1e-3, atol=1e-4)
    ref = sig.lfilter(b, a, x, axis=-1)
    np.testing.assert_allclose(y2, ref, rtol=1e-2, atol=1e-3)


def test_iir_complex():
    b, a = create_iir_peak_1_filter(0.25, 0.999)
    x = (RNG.standard_normal((1, 512)) + 1j * RNG.standard_normal((1, 512))).astype(
        np.complex64
    )
    _, y = iir_filter_complex(b, a, iir_init_state(2, 2), jnp.asarray(x))
    ref = sig.lfilter(b, a, x, axis=-1)
    np.testing.assert_allclose(np.asarray(y), ref, rtol=1e-2, atol=1e-3)


# ----------------------------------------------------------------- misc ops


def test_chebyshev_sine_accuracy():
    x = np.linspace(-0.5, 0.5, 4001).astype(np.float32)
    y = np.asarray(chebyshev_sine(jnp.asarray(x)))
    np.testing.assert_allclose(y, np.sin(2 * np.pi * x), atol=5e-7)


def test_agc_drives_power_to_target():
    x = (3.0 * (RNG.standard_normal((1, 1024)) + 1j * RNG.standard_normal((1, 1024)))).astype(
        np.complex64
    )
    gain = agc_init_state(1)
    for _ in range(40):
        gain, y = agc_process(gain, jnp.asarray(x), target_power=0.5, beta=0.2)
    p = float(np.mean(np.abs(np.asarray(y)) ** 2))
    np.testing.assert_allclose(p, 0.5, rtol=0.02)


def test_discriminator_recovers_tone():
    fs, fd = 256e3, 75e3
    n = 8192
    t = np.arange(n) / fs
    msg = 0.5 * np.sin(2 * np.pi * 1000 * t)
    phase = 2 * np.pi * fd * np.cumsum(msg) / fs
    x = np.exp(1j * phase).astype(np.complex64)[None, :]
    prev = jnp.zeros((1,), jnp.float32)
    _, y = fm_discriminate(prev, jnp.asarray(x), fd, fs)
    y = np.asarray(y)[0]
    # recovered = msg * 0.5 (the deliberate half-scale)
    np.testing.assert_allclose(y[10:], 0.5 * msg[10:], atol=1e-3)


def test_discriminator_streaming():
    x = np.exp(1j * np.cumsum(RNG.standard_normal(512) * 0.1)).astype(np.complex64)[
        None, :
    ]
    prev = jnp.zeros((1,), jnp.float32)
    _, y1 = fm_discriminate(prev, jnp.asarray(x), 75e3, 256e3)
    st = prev
    outs = []
    for blk in np.split(x, 4, axis=-1):
        st, y = fm_discriminate(st, jnp.asarray(blk), 75e3, 256e3)
        outs.append(np.asarray(y))
    np.testing.assert_allclose(np.asarray(y1), np.concatenate(outs, -1), atol=1e-6)


def test_harmonic_pll_mixer():
    n = 1024
    dt = np.linspace(0, 10, n).astype(np.float32)[None, :] % 1.0 - 0.5
    x = (RNG.standard_normal((1, n)) + 1j * RNG.standard_normal((1, n))).astype(
        np.complex64
    )
    y = apply_harmonic_pll(jnp.asarray(dt), jnp.asarray(x), 2.0, 0.1)
    ref = x * np.exp(1j * 2 * np.pi * (dt * 2.0 + 0.1))
    np.testing.assert_allclose(np.asarray(y), ref, atol=1e-5)


def test_polyphase_decimate_planes_matches_complex():
    from fm_radio.ops.fir import polyphase_decimate, polyphase_decimate_p

    taps = create_fir_lpf(64, 0.2)
    x = (RNG.standard_normal((3, 1024)) + 1j * RNG.standard_normal((3, 1024))).astype(
        np.complex64
    )
    st0 = jnp.zeros((3, 60), jnp.complex64)
    st_c, y_c = polyphase_decimate(taps, st0, jnp.asarray(x), 4)
    st_p, (yr, yi) = polyphase_decimate_p(
        taps, st0, (jnp.asarray(x.real), jnp.asarray(x.imag)), 4
    )
    np.testing.assert_array_equal(np.asarray(y_c.real), np.asarray(yr))
    np.testing.assert_array_equal(np.asarray(y_c.imag), np.asarray(yi))
    np.testing.assert_array_equal(np.asarray(st_c), np.asarray(st_p))

    # imag_out=False: same real output, same carried state
    st_p2, yr2 = polyphase_decimate_p(
        taps, st0, (jnp.asarray(x.real), jnp.asarray(x.imag)), 4, imag_out=False
    )
    np.testing.assert_array_equal(np.asarray(yr2), np.asarray(yr))
    np.testing.assert_array_equal(np.asarray(st_p2), np.asarray(st_p))


def test_hilbert_planes_matches_complex():
    from fm_radio.ops.fir import hilbert_fir, hilbert_fir_p, hilbert_init_state

    taps = create_fir_hilbert(65)
    x = RNG.standard_normal((2, 700)).astype(np.float32)
    st0 = hilbert_init_state(2, 65)
    _, y = hilbert_fir(taps, st0, jnp.asarray(x))
    _, (re, im) = hilbert_fir_p(taps, st0, jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(y.real), np.asarray(re))
    np.testing.assert_array_equal(np.asarray(y.imag), np.asarray(im))
