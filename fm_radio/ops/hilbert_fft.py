"""FFT-based Hilbert transform (block analytic signal).

Parity: ``HilbertFFTTransform`` (``src/dsp/hilbert_fft_transform.h:7-28``) —
the reference's alternative to the 65-tap FIR (kept commented-out at
``broadcast_fm_demod.cpp:409``): Y[0] and Y[N/2] unchanged, positive
frequencies doubled, negative zeroed.  Unlike the FIR it has no carried state
(whole-block transform) and no group delay — more parallel-friendly for offline
whole-stream processing; the FIR variant remains the streaming default for
reference parity.
"""

from __future__ import annotations

import jax.numpy as jnp


def hilbert_fft(x: jnp.ndarray) -> jnp.ndarray:
    """x: [..., N] real -> [..., N] complex analytic signal."""
    n = x.shape[-1]
    spec = jnp.fft.fft(x, axis=-1)
    h = jnp.zeros((n,), jnp.float32)
    h = h.at[0].set(1.0)
    if n % 2 == 0:
        h = h.at[n // 2].set(1.0)
        h = h.at[1 : n // 2].set(2.0)
    else:
        h = h.at[1 : (n + 1) // 2].set(2.0)
    return jnp.fft.ifft(spec * h, axis=-1)


def delay_line(state: jnp.ndarray, x: jnp.ndarray):
    """K-sample delay with carried state (``src/dsp/delay_line.h:9-61``).

    state: [C, K]; x: [C, N].  Returns (new_state, y) with y[n] = x[n-K].
    """
    k = state.shape[-1]
    x_pad = jnp.concatenate([state, x], axis=-1)
    # positive slice start: `-k:` with k==0 would return the WHOLE array
    return x_pad[:, x_pad.shape[-1] - k:], x_pad[:, : x.shape[-1]]
