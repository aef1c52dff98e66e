"""Feed-forward FIR ops: streaming FIR, polyphase decimator, Hilbert transform.

Formulation: instead of the reference's per-output SIMD dot products
(``fir_filter.h:90-102``, ``polyphase_filter.h:190-202``), each filter is a
matrix product — the polyphase decimator multiplies tiles of the padded
input by a banded tap matrix, which XLA hands to its GEMM libraries.  Cross-block continuity is an
explicit carried tail of ``(K-1)*M`` samples (the overlap-save state), which is
also the halo exchanged between time shards.

Semantics parity: identical to ``FIR_Filter::process`` (``fir_filter.h:30-57``),
``PolyphaseDownsampler::process`` (``polyphase_filter.h:36-64``) and
``Hilbert_FIR_Filter::process`` (``hilbert_fir_filter.h:25-46``), including the
head/tail history handling at block boundaries (verified by streaming-vs-oracle
unit tests).

All arrays are ``[C, T]`` (channel-major); taps are real float32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_DN = ("NCH", "OIH", "NCH")


def _conv_f32(lanes: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """out[b, i] = sum_{p,k} lanes[b, p, i+k] * kernel[p, k].

    lanes: [B, P, W] float32; kernel: [P, K] float32 -> [B, W-K+1] float32.
    """
    out = jax.lax.conv_general_dilated(
        lanes,
        kernel[None, :, :],  # [O=1, I=P, K]
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=_DN,
        preferred_element_type=jnp.float32,
        # Full f32: a reduced-precision default (TF32 on a GPU) is far
        # below audio-SNR requirements for the small-output tail.
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[:, 0, :]


def _banded_matrix(w: jnp.ndarray, m: int, no: int) -> jnp.ndarray:
    """Banded tap matrix A[j*m + k, j] = w[k] so that a window @ A yields
    ``no`` consecutive decimated-correlation outputs in one matmul."""
    nn = w.shape[0]
    width = (no - 1) * m + nn
    rows = jnp.arange(width)[:, None]
    cols = jnp.arange(no)[None, :]
    k = rows - cols * m
    valid = (k >= 0) & (k < nn)
    return jnp.where(valid, jnp.take(w, jnp.clip(k, 0, nn - 1)), 0.0).astype(
        jnp.float32
    )


# Filter-product precision on a GPU: BF16_BF16_F32_X3, three bf16 products
# summed in f32 (~2^-17 relative error).  Precision.HIGH means TF32 on a
# GPU (a 10-bit mantissa).  Measured on an H100 at 2048 x 131072: 11.2 ms
# per block against 11.0 for HIGH and 15.2 for HIGHEST; the audio SNR of
# each against HIGHEST is in PERF.md (precision decision) and gated by
# tests/test_gpu_accuracy.py::test_audio_precision_on_hardware.
FIR_PRECISION = jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3


def filter_precision(precision):
    """``precision`` on a GPU backend; HIGHEST elsewhere: XLA's CPU backend
    computes f32 products in full and does not implement every dot
    algorithm.  Read at trace time."""
    if jax.default_backend() == "gpu":
        return precision
    return jax.lax.Precision.HIGHEST

# Outputs per banded-matmul tile (see _apply_real_taps).
TILE_OUTPUTS = 128


def _conv_small(lanes: jnp.ndarray, w: jnp.ndarray, m: int) -> jnp.ndarray:
    """Polyphase decimation as a plain conv (one output feature): fine for
    small outputs where the N=1 matvec lowering doesn't matter."""
    nn = w.shape[0]
    kp = nn // m
    kernel = w.reshape(kp, m).T.astype(jnp.float32)  # [m, K]
    fr = lanes.reshape(lanes.shape[0], lanes.shape[-1] // m, m).transpose(0, 2, 1)
    return _conv_f32(fr, kernel)


def _apply_real_taps(x_pad: jnp.ndarray, w: jnp.ndarray, m: int) -> jnp.ndarray:
    """Decimating correlation y[c, i] = sum_k w[k] * x_pad[c, i*m + k].

    ``x_pad``: [C, T_pad] real or complex; ``w``: [NN] float32 with NN = m*K
    (for m == 1 this is a plain stride-1 FIR).  Complex inputs are split into
    real/imag batch lanes since the taps are real.

    Formulation: tiles of ``no`` consecutive outputs are computed as one
    [B*t, W] x [W, no] matmul against a banded tap matrix (W = no*m + nn - m).
    The reference computes each output as an independent SIMD dot product
    (``polyphase_filter.h:190-202``); a direct translation (conv with one
    output feature) lowers to an N=1 matvec.  The band
    is split at the tile boundary into two matmuls over pure reshape VIEWS of
    the input (body [B,t,no*m] and the nn-m overlap tail) so no window copy,
    pad, or concat of the full signal is ever materialized; leftover outputs
    that don't fill a tile go through the small-conv path.
    """
    nn = w.shape[0]
    assert nn % m == 0
    kp = nn // m
    c, t_pad = x_pad.shape
    assert (t_pad - (kp - 1) * m) % m == 0
    n_out = t_pad // m - kp + 1

    if jnp.iscomplexobj(x_pad):
        lanes = jnp.concatenate([x_pad.real, x_pad.imag], axis=0)
    else:
        lanes = x_pad.astype(jnp.float32)

    # Tile width (outputs per banded matmul).  Trade-off: larger tiles mean a
    # smaller overlap-tail re-read (nn-m of every no*m input samples) but more
    # zero-padding FLOPs in the band (density nn/(no*m + nn - m)).
    no = TILE_OUTPUTS
    width = no * m + nn - m
    t_full = 0
    if n_out >= 16 and t_pad >= width:
        t_full = min((t_pad - width) // (no * m) + 1, t_pad // (no * m) - 1)

    if t_full < 1:
        y = _conv_small(lanes, w, m)
    else:
        b = lanes.shape[0]
        body = lanes[:, : t_full * no * m].reshape(b, t_full, no * m)
        tail = lanes[:, no * m : (t_full + 1) * no * m].reshape(b, t_full, no * m)[
            :, :, : nn - m
        ]
        a = _banded_matrix(w, m, no)  # [W, no]
        y = (
            jnp.einsum(
                "btw,wj->btj",
                body,
                a[: no * m],
                preferred_element_type=jnp.float32,
                precision=filter_precision(FIR_PRECISION),
            )
            + jnp.einsum(
                "btw,wj->btj",
                tail,
                a[no * m :],
                preferred_element_type=jnp.float32,
                precision=filter_precision(FIR_PRECISION),
            )
        ).reshape(b, t_full * no)
        rem = n_out - t_full * no
        if rem > 0:
            y_rem = _conv_small(lanes[:, t_full * no * m :], w, m)
            y = jnp.concatenate([y, y_rem], axis=-1)
        y = y[:, :n_out]

    if jnp.iscomplexobj(x_pad):
        return jax.lax.complex(y[:c], y[c:])
    return y


# ---------------------------------------------------------------------------
# Plain streaming FIR (stride 1)
# ---------------------------------------------------------------------------


def fir_init_state(channels: int, num_taps: int, dtype=jnp.float32) -> jnp.ndarray:
    """Carried history of the last ``num_taps - 1`` input samples, zeros at
    start (``fir_filter.h:24-28``)."""
    return jnp.zeros((channels, num_taps - 1), dtype=dtype)


def fir_filter(taps, state: jnp.ndarray, x: jnp.ndarray):
    """Streaming FIR: y[n] = sum_j h[j] x[n-j] with carried history.

    Returns ``(new_state, y)`` with ``y.shape == x.shape``.
    """
    taps = jnp.asarray(taps, dtype=jnp.float32)
    w_rev = taps[::-1]
    if jnp.iscomplexobj(x):
        hr, yr = _decimate_core(w_rev, state.real, x.real, 1)
        hi, yi = _decimate_core(w_rev, state.imag, x.imag, 1)
        return jax.lax.complex(hr, hi), jax.lax.complex(yr, yi)
    new_state, y = _decimate_core(w_rev, state.astype(jnp.float32), x, 1)
    return new_state.astype(x.dtype), y.astype(x.dtype)


# ---------------------------------------------------------------------------
# Polyphase decimator
# ---------------------------------------------------------------------------


def polyphase_init_state(
    channels: int, factor: int, taps_per_phase: int, dtype=jnp.float32
) -> jnp.ndarray:
    """Carried tail of ``(K-1)*M`` input samples (overlap-save state)."""
    return jnp.zeros((channels, (taps_per_phase - 1) * factor), dtype=dtype)


def _decimate_core(w_rev: jnp.ndarray, hist: jnp.ndarray, x: jnp.ndarray, m: int):
    """Streaming decimated correlation on ONE real plane.

    hist: [B, (K-1)*m] carried tail; x: [B, T].  Returns (new_hist, y [B, T/m])
    WITHOUT materializing a full-length concat(hist, x): the first K-1
    outputs come from a small head buffer, the bulk straight from ``x``.
    """
    nn = w_rev.shape[0]
    kp = nn // m
    t = x.shape[-1]
    if t < nn:  # block shorter than the filter: plain overlap-save concat
        x_pad = jnp.concatenate([hist, x], axis=-1)
        return x_pad[:, x_pad.shape[-1] - (kp - 1) * m :], _apply_real_taps(
            x_pad, w_rev, m
        )
    new_hist = x[:, t - (kp - 1) * m :]
    if kp > 1:
        head = jnp.concatenate([hist, x[:, :nn]], axis=-1)
        y_head = _apply_real_taps(head, w_rev, m)[:, : kp - 1]
        y_bulk = _apply_real_taps(x, w_rev, m)
        y = jnp.concatenate([y_head, y_bulk], axis=-1)
    else:
        y = _apply_real_taps(x, w_rev, m)
    return new_hist, y


def polyphase_decimate(taps, state: jnp.ndarray, x: jnp.ndarray, factor: int):
    """Decimate-by-``factor`` FIR: computes only every M-th output of the
    underlying NN = M*K tap filter (``polyphase_filter.h:36-64``).

    ``taps``: [NN] natural-order impulse response; ``x``: [C, N*M].
    Returns ``(new_state, y)`` with ``y``: [C, N].  Output sample ``i`` is the
    filter evaluated with its window ending at input sample ``(i+1)*M - 1``,
    exactly like the reference.
    """
    taps = jnp.asarray(taps, dtype=jnp.float32)
    nn = taps.shape[0]
    assert nn % factor == 0, "taps length must be factor * taps_per_phase"
    assert x.shape[-1] % factor == 0
    w_rev = taps[::-1]
    if jnp.iscomplexobj(x):
        hr, yr = _decimate_core(w_rev, state.real, x.real, factor)
        hi, yi = _decimate_core(w_rev, state.imag, x.imag, factor)
        return jax.lax.complex(hr, hi), jax.lax.complex(yr, yi)
    new_state, y = _decimate_core(w_rev, state.astype(jnp.float32), x, factor)
    return new_state, y


def polyphase_decimate_p(taps, state: jnp.ndarray, xp, factor: int,
                         imag_out: bool = True):
    """Plane-tuple variant: ``xp`` = (re [C, T], im [C, T]) f32; state stays
    complex64 (small).  Returns (state', (yr, yi)), or (state', yr) when
    ``imag_out=False`` (the imag tail is still carried, but its decimated
    output — dead in the L+R path, which keeps only Re — is never computed).

    This is the production demod path: complex signals travel as separate f32
    planes (keeping planes explicit saves the real()/imag() extraction passes
    over multi-GB blocks).
    """
    taps = jnp.asarray(taps, dtype=jnp.float32)
    nn = taps.shape[0]
    assert nn % factor == 0
    xr, xi = xp
    assert xr.shape[-1] % factor == 0
    w_rev = taps[::-1]
    hr, yr = _decimate_core(w_rev, state.real, xr, factor)
    if not imag_out and xi.shape[-1] >= nn:
        hist = nn - factor
        hi = xi[:, xi.shape[-1] - hist :]
        return jax.lax.complex(hr, hi), yr
    hi, yi = _decimate_core(w_rev, state.imag, xi, factor)
    if not imag_out:
        return jax.lax.complex(hr, hi), yr
    return jax.lax.complex(hr, hi), (yr, yi)


# ---------------------------------------------------------------------------
# Hilbert transform FIR
# ---------------------------------------------------------------------------


def hilbert_init_state(channels: int, num_taps: int) -> jnp.ndarray:
    return jnp.zeros((channels, num_taps - 1), dtype=jnp.float32)


def hilbert_fir_p(taps, state: jnp.ndarray, x: jnp.ndarray):
    """Analytic-signal generator, plane-tuple output
    (``hilbert_fir_filter.h:25-46``).

    Real plane: input delayed by (K-1)/2 samples; imag plane: Hilbert FIR.
    ``taps`` from :func:`create_fir_hilbert` (odd length K); ``x``/state f32.
    Returns ``(new_state, (re, im))``.
    """
    taps = jnp.asarray(taps, dtype=jnp.float32)
    k = taps.shape[0]
    m = (k - 1) // 2
    t = x.shape[-1]
    new_state, im = _decimate_core(taps[::-1], state, x, 1)
    if t >= k:
        # delayed-real = x_pad[m : m+T] built from the small state head only
        re = jnp.concatenate([state[:, m:], x[:, : t - m]], axis=-1)
    else:
        x_pad = jnp.concatenate([state, x], axis=-1)
        re = jax.lax.dynamic_slice_in_dim(x_pad, m, t, axis=-1)
    return new_state, (re, im)


def hilbert_fir(taps, state: jnp.ndarray, x: jnp.ndarray):
    """Complex-output wrapper around :func:`hilbert_fir_p`."""
    new_state, (re, im) = hilbert_fir_p(taps, state, x)
    return new_state, jax.lax.complex(re, im)


# ---------------------------------------------------------------------------
# Polyphase upsampler (parity with PolyphaseUpsampler, polyphase_filter.h:90-185;
# unused by the demod chain but part of the reference's public DSP surface)
# ---------------------------------------------------------------------------


def polyphase_upsample_init_state(
    channels: int, taps_per_phase: int, dtype=jnp.float32
) -> jnp.ndarray:
    return jnp.zeros((channels, taps_per_phase - 1), dtype=dtype)


def polyphase_upsample(taps, state: jnp.ndarray, x: jnp.ndarray, factor: int):
    """Interpolate-by-``factor``: zero-stuff then LPF, computed phase-wise.

    ``taps``: [L*K] natural-order LPF impulse response (will be scaled by L
    like the reference's repacking at ``polyphase_filter.h:112-122``).
    Returns ``(new_state, y)`` with y: [C, N*L].
    """
    taps = jnp.asarray(taps, dtype=jnp.float32) * float(factor)
    nn = taps.shape[0]
    assert nn % factor == 0
    k = nn // factor
    x_pad = jnp.concatenate([state.astype(x.dtype), x], axis=-1)  # [C, N+K-1]
    # positive slice start: `-(k-1):` with k==1 would return the WHOLE array
    new_state = x_pad[:, x_pad.shape[-1] - (k - 1):]

    # Phase p of output i uses taps h[p], h[p+L], ... against the last K inputs.
    # y[i*L + p] = sum_q h_rev_p[q] * x_pad[i + q]  (matches the reference's
    # repacked-coefficient apply at polyphase_filter.h:128-185).
    w = taps[::-1]  # reversed full filter
    if jnp.iscomplexobj(x_pad):
        lanes = jnp.concatenate([x_pad.real, x_pad.imag], axis=0)
    else:
        lanes = x_pad.astype(jnp.float32)
    outs = []
    for p in range(factor):
        # phase p of the output uses taps h[u*L + p]; in reversed-tap
        # coordinates that is w[(L-1-p)::L]
        wp = w[factor - 1 - p :: factor]  # [K]
        y_p = _conv_f32(lanes[:, None, :], wp[None, :])
        outs.append(y_p)
    y = jnp.stack(outs, axis=-1).reshape(lanes.shape[0], -1)  # interleave
    if jnp.iscomplexobj(x_pad):
        c = x.shape[0]
        return new_state, jax.lax.complex(y[:c], y[c:])
    return new_state, y
