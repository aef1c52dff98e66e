"""Polyphase FFT filterbank channelizer: wideband IQ -> M station channels.

New component (no reference analogue — the reference tunes one station per
process).  Feeds the multi-channel configs: a wideband front-end capture at
Fs_wide = M * fs_channel is split into M critically-sampled channels, each
centered on k * fs_channel, which then enter the channel-batched demodulator.

Formulation: the polyphase partial filters are K shifted multiply-adds
that XLA fuses into one pass, and the cross-phase DFT is one dense
[T/M, M] x [M, M] product — both dense, both compiler-friendly.

Math (critically sampled DFT filterbank, h = prototype LPF of length M*K;
frames[j, p] = x[j*M + p]):
    z_p[n] = sum_r h_rev[r*M + p] * frames[n + r, p]
    y_k[n] = sum_p exp(-j 2 pi k p / M) * z_p[n]       (forward FFT over p)
Channel k is x mixed down by k*Fs/M and LPF'd to Fs/M at unit passband gain
(the prototype's taps sum to 1, so a station keeps its capture amplitude) —
the e^{-j} sign is pinned by test_channelizer_matches_direct_downconversion.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from fm_radio.ops.design import create_fir_lpf


def make_channelizer_taps(
    num_channels: int, taps_per_phase: int = 16, rolloff: float = 0.95
) -> np.ndarray:
    """Prototype LPF: cutoff at the channel Nyquist with early roll-off
    (same policy as the decimators, broadcast_fm_demod.cpp:129)."""
    m, k = num_channels, taps_per_phase
    return create_fir_lpf(m * k, rolloff / m)


def channelizer_init_state(num_channels: int, taps_per_phase: int) -> jnp.ndarray:
    """Carried raw-IQ tail of (K-1)*M samples (created on device)."""
    n = (taps_per_phase - 1) * num_channels
    return jax.jit(lambda: jnp.zeros((n,), jnp.complex64))()


def channelize_p(taps, state_p, xp, num_channels: int):
    """Plane-tuple channelizer (the production form).

    xp: (re, im) [T] f32 wideband planes; state_p: (re, im) [(K-1)*M] f32.
    Returns (state_p', (y_re, y_im) [M, T/M] f32).

    - phase filter: frames = x.reshape(T/M + K-1, M) (pure view, phase on
      the minor axis); z[n, p] = sum_r w[r, p] * frames[n+r, p] is K shifted
      multiply-adds over overlapping row slices — XLA fuses them into a
      single pass over the input.
    - DFT across phases: y[n, k] = sum_p z[n, p] W[p, k] is a dense
      [T/M, M] x [M, M] product (4 real products for the complex one).
    """
    taps = np.asarray(taps, np.float32)
    t_len = (xp if not isinstance(xp, (tuple, list)) else xp[0]).shape[-1]
    assert taps.shape[0] % num_channels == 0 and t_len % num_channels == 0
    return _channelize_xla_p(taps, state_p, xp, num_channels)


def _channelize_xla_p(taps, state_p, xp, num_channels: int):
    """The pure-jnp filterbank math (vmap-safe)."""
    m = num_channels
    k = taps.shape[0] // m
    packed = not isinstance(xp, (tuple, list))
    sr, si = state_p

    if packed:
        # packed u8 IQ words (utils/transfer.pack_iq_u8), unpacked exactly
        from fm_radio.utils.transfer import unpack_iq_words

        xr, xi = unpack_iq_words(xp)
    else:
        xr, xi = xp

    xr_pad = jnp.concatenate([sr, xr], axis=-1)
    xi_pad = jnp.concatenate([si, xi], axis=-1)
    # positive slice start: `-(k-1)*m:` with k==1 would carry the whole block
    tail = xr_pad.shape[-1] - (k - 1) * m
    new_state = (xr_pad[tail:], xi_pad[tail:])
    n_frames = xr_pad.shape[-1] // m  # T/M + K - 1
    n_out = n_frames - (k - 1)

    # frames[j, p] = x_pad[j*M + p]; z_p[n] = sum_r taps_rev[r*M+p] frames[n+r, p]
    fr = xr_pad.reshape(n_frames, m)
    fi = xi_pad.reshape(n_frames, m)
    w = taps[::-1].reshape(k, m)
    zr = sum(fr[r : r + n_out, :] * w[r][None, :] for r in range(k))
    zi = sum(fi[r : r + n_out, :] * w[r][None, :] for r in range(k))

    # y[n, k] = sum_p z[n, p] exp(-2j pi k p / M)  (== jnp.fft.fft over p)
    p_idx = np.arange(m)
    ang = -2.0 * np.pi * np.outer(p_idx, p_idx) / m
    w_re = jnp.asarray(np.cos(ang).astype(np.float32))
    w_im = jnp.asarray(np.sin(ang).astype(np.float32))
    hi = jax.lax.Precision.HIGHEST
    y_re = (jnp.dot(zr, w_re, precision=hi) - jnp.dot(zi, w_im, precision=hi)).T
    y_im = (jnp.dot(zr, w_im, precision=hi) + jnp.dot(zi, w_re, precision=hi)).T
    return new_state, (y_re, y_im)


def channelize_batch_p(taps, state_p, xp, num_channels: int,
                       out: str = "f32"):
    """W independent wideband captures through ONE filterbank program.

    state_p: (sr, si) each [W, (K-1)*M]; xp: [W, T] packed f32 words or
    (re, im) planes each [W, T].  Returns (state_p', (y_re, y_im)
    [W, M, T/M]) — or, with ``out="i8"``, (state_p', y_i8 [2, W, M, T/M]
    int8): the planes re-quantized to the capture's u8 grid in the demod's
    int8-plane convention (models/wideband.py's "i8" bridge).

    This is the wideband front door of the stations-at-scale path: W
    captures x M channels fill the demodulator's channel axis with
    C = W*M stations (the reference consumes ONE wideband capture per
    process, app.cpp:39-64)."""
    m = num_channels
    taps = np.asarray(taps, np.float32)
    packed = not isinstance(xp, (tuple, list))
    if packed:
        st, y = jax.vmap(
            lambda s0, s1, xw: _channelize_xla_p(taps, (s0, s1), xw, m)
        )(state_p[0], state_p[1], xp)
    else:
        st, y = jax.vmap(
            lambda s0, s1, x0, x1: _channelize_xla_p(taps, (s0, s1),
                                                     (x0, x1), m)
        )(state_p[0], state_p[1], xp[0], xp[1])
    if out == "i8":
        # unit passband gain: a station's samples are already on the u8
        # grid's scale; -1 matches split_iq_i8's (u8 - 128) storage
        def q8(p):
            v = jnp.clip(jnp.round(p) - 1.0, -128.0, 127.0)
            return v.astype(jnp.int8)

        return st, jnp.stack([q8(y[0]), q8(y[1])])  # [2, W, m, B]
    assert out == "f32", out
    return st, y


def channelize(taps, state: jnp.ndarray, x: jnp.ndarray, num_channels: int):
    """x: [T] wideband complex64, T divisible by M.  Returns
    (new_state, y [M, T/M] complex64) — channel k centered at +k*Fs/M
    (wrapping: channels above M/2 are negative frequencies).

    Complex-dtype wrapper over :func:`channelize_p`.
    """
    m = num_channels
    taps = jnp.asarray(taps, jnp.float32)
    nn = taps.shape[0]
    k = nn // m
    st_p = (state.real, state.imag)
    st_p2, (y_re, y_im) = channelize_p(taps, st_p, (x.real, x.imag), m)
    new_state = jax.lax.complex(*st_p2)
    return new_state, jax.lax.complex(y_re, y_im)


def channelize_packed(taps, state: jnp.ndarray, w_packed, num_channels: int):
    """Packed-ingest complex-out wrapper: w_packed [T] f32 of u8 IQ words
    (utils/transfer.pack_iq_u8 — the capture's native bytes at half the
    transfer cost).  Returns (new_state, y [M, T/M] complex64)."""
    st_p = (state.real, state.imag)
    st_p2, (y_re, y_im) = channelize_p(taps, st_p, jnp.asarray(w_packed),
                                       num_channels)
    return jax.lax.complex(*st_p2), jax.lax.complex(y_re, y_im)


def channelize_batch(taps, state, x, num_channels):
    """Batched wideband inputs: x [W, T] -> y [W, M, T/M]."""
    return jax.vmap(lambda s, xx: channelize(taps, s, xx, num_channels))(state, x)


def stream_selected(taps, state, w, num_channels: int, select, consume,
                    chunk_min: int = 1 << 22):
    """Chunked packed-word wideband streaming: filterbank in constant device
    memory per chunk, SELECTED station rows fetched (f32-safe) and handed to
    ``consume`` as centered complex64 [len(select), T'].  The filterbank's
    (K-1)-frame tail carries exactly across chunks; returns the carried
    state so callers can keep streaming (tools/soak.py windows).  The ONE
    production wideband ingest loop — shared by ``fmtpu stations`` and the
    soak gate."""
    from fm_radio.utils.transfer import fetch, take_rows

    m = num_channels
    sel = np.asarray(select, np.float32)
    n = (len(w) // m) * m
    chunk = max(chunk_min, m)
    chunk -= chunk % m
    for i0 in range(0, n, chunk):
        state, y = channelize_packed(taps, state, w[i0 : min(i0 + chunk, n)], m)
        # the 1/m scale is immaterial to the demod (its discriminator and
        # AGCs are amplitude-invariant) and kept for output compatibility
        consume(fetch(take_rows(y, sel)) / m)
    return state
