"""Filter-designer oracle tests (SciPy / hand-computed references).

Validates coefficient parity with ``src/dsp/filter_designer.cpp`` semantics.
"""

import numpy as np
import pytest
import scipy.signal as sig

from fm_radio.ops import (
    create_fir_bpf,
    create_fir_hilbert,
    create_fir_hpf,
    create_fir_lpf,
    create_iir_peak_1_filter,
    create_iir_notch_filter,
    create_iir_single_pole_lpf,
    prewarp_normalised_frequency,
)
from fm_radio.ops.windows import window_hamming


def ref_fir_lpf(n, k):
    """Direct transcription of filter_designer.cpp:84-107 math (un-reversed)."""
    i = np.arange(n, dtype=np.float64)
    m = n - 1
    t0 = 2 * np.pi * i / m
    t1 = i - m / 2
    w = 0.53836 - 0.46164 * np.cos(t0)
    return w * k * np.sinc(k * t1)


def test_fir_lpf_matches_reference_math():
    for n, k in [(64, 0.11875), (128, 0.234), (33, 0.5)]:
        h = create_fir_lpf(n, k)
        np.testing.assert_allclose(h, ref_fir_lpf(n, k), rtol=1e-6, atol=1e-8)


def test_fir_lpf_dc_gain_near_unity():
    h = create_fir_lpf(64, 0.25)
    assert abs(h.sum() - 1.0) < 0.01


def test_fir_lpf_frequency_response():
    k = 0.25
    h = create_fir_lpf(128, k)
    w, resp = sig.freqz(h, worN=2048)
    kn = w / np.pi
    # passband within 1 dB, stopband below -40 dB (hamming gives ~ -53 dB)
    pass_mask = kn < 0.8 * k
    stop_mask = kn > 1.4 * k
    assert np.all(np.abs(20 * np.log10(np.abs(resp[pass_mask]))) < 1.0)
    assert np.all(20 * np.log10(np.abs(resp[stop_mask])) < -40.0)


def test_fir_hpf_is_complement():
    n, k = 65, 0.3
    lpf = create_fir_lpf(n, k)
    hpf = create_fir_hpf(n, k)
    # h_hpf = window*sinc - h_lpf  => at DC, sum(hpf) ~ 0
    assert abs(hpf.sum()) < 0.01
    w, resp = sig.freqz(hpf, worN=1024)
    kn = w / np.pi
    assert np.all(20 * np.log10(np.abs(resp[kn < 0.6 * k]) + 1e-12) < -35.0)
    assert np.all(np.abs(20 * np.log10(np.abs(resp[kn > 1.5 * k]))) < 1.0)


def test_fir_bpf_passes_band():
    h = create_fir_bpf(129, 0.2, 0.4)
    w, resp = sig.freqz(h, worN=2048)
    kn = w / np.pi
    mid = (kn > 0.27) & (kn < 0.33)
    stop = (kn < 0.1) | (kn > 0.55)
    assert np.all(np.abs(20 * np.log10(np.abs(resp[mid]))) < 1.0)
    assert np.all(20 * np.log10(np.abs(resp[stop]) + 1e-12) < -40.0)


def test_hilbert_taps():
    h = create_fir_hilbert(65)
    m = 32
    assert h[m] == 0.0
    # antisymmetric: h[m+j] = -h[m-j]
    np.testing.assert_allclose(h[m + 1 :], -h[m - 1 :: -1], rtol=1e-7)
    # odd offsets: 2/(pi*n)
    np.testing.assert_allclose(h[m + 1], 2 / np.pi, rtol=1e-6)
    np.testing.assert_allclose(h[m + 3], 2 / (3 * np.pi), rtol=1e-6)
    assert h[m + 2] == 0.0


def test_hilbert_response_quadrature():
    h = create_fir_hilbert(65)
    w, resp = sig.freqz(h, worN=1024)
    kn = w / np.pi
    band = (kn > 0.1) & (kn < 0.9)
    # ~unit magnitude (the reference windows nothing here, so Gibbs ripple of
    # ~±5% is expected), -90 degree phase after removing the 32-sample delay
    np.testing.assert_allclose(np.abs(resp[band]), 1.0, atol=0.06)
    phase = np.angle(resp[band] * np.exp(1j * w[band] * 32))
    np.testing.assert_allclose(phase, -np.pi / 2, atol=0.05)


def test_prewarp():
    # Ka = 2/pi tan(pi/2 Kd); for small k, Ka ~ Kd
    assert abs(prewarp_normalised_frequency(0.01) - 0.01) < 1e-4
    np.testing.assert_allclose(
        prewarp_normalised_frequency(0.5), 2 / np.pi * np.tan(np.pi / 4)
    )


def test_single_pole_lpf_matches_bilinear_butterworth():
    k = 100.0 / (128000.0 / 2.0)  # the pilot-PLL loop filter design point
    b, a = create_iir_single_pole_lpf(k)
    # Against scipy's bilinear transform of H(s)=1/(1+s/wc) with prewarped wc
    fs = 2.0
    wc = np.pi * prewarp_normalised_frequency(k)  # rad/s at fs=2
    b_ref, a_ref = sig.bilinear([wc], [1.0, wc], fs=fs / 2)
    np.testing.assert_allclose(b, b_ref, rtol=1e-5)
    np.testing.assert_allclose(a, a_ref, rtol=1e-5)
    # DC gain 1 (to float32 rounding)
    np.testing.assert_allclose(b.sum() / a.sum(), 1.0, rtol=1e-5)


def test_peak_filter_unity_at_peak():
    k = 19000.0 / (128000.0 / 2.0)
    b, a = create_iir_peak_1_filter(k, 0.9999)
    w, resp = sig.freqz(b, a, worN=[np.pi * k])
    np.testing.assert_allclose(np.abs(resp[0]), 1.0, rtol=1e-3)
    # strong rejection away from the peak
    w2, resp2 = sig.freqz(b, a, worN=[np.pi * k * 2])
    assert np.abs(resp2[0]) < 0.01


def test_notch_filter_kills_notch_frequency():
    k = 0.3
    b, a = create_iir_notch_filter(k, 0.99)
    _, resp = sig.freqz(b, a, worN=[np.pi * k])
    assert np.abs(resp[0]) < 1e-4  # float32 coefficient rounding
    _, resp_pass = sig.freqz(b, a, worN=[np.pi * 0.9])
    np.testing.assert_allclose(np.abs(resp_pass[0]), 1.0, atol=0.05)


def test_window_values():
    # hamming at x=pi (center of window) is the max: 0.53836+0.46164 = 1.0
    np.testing.assert_allclose(window_hamming(np.array([np.pi])), [1.0], atol=1e-7)
