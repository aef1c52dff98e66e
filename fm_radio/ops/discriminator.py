"""Quadrature FM discriminator.

Parity: ``FM_Demod::Process`` (``src/fm_demod/fm_demod.cpp:30-45``):
y[n] = wrap(theta[n] - theta[n-1]) / (2*pi*Fd*Ts) * 0.5, carrying prev_theta.
The deliberate 0.5 scale is compensated by the *2 in the audio mixer
(``broadcast_fm_demod.cpp:582-584``) — replicated, not "fixed".

Formulation: the per-sample loop is embarrassingly parallel given a one-sample
halo — atan2 over the block, one shifted difference, single-branch wrap.
"""

from __future__ import annotations

import jax.numpy as jnp

from fm_radio.ops.cmath import wrap_phase


def fm_discriminate_p(prev_theta: jnp.ndarray, xp, fd: float, fs: float):
    """Plane-tuple variant: xp = (re [C, N], im [C, N]) f32.

    Returns (new_prev_theta [C], y [C, N] float32).
    """
    xr, xi = xp
    theta = jnp.arctan2(xi, xr)  # [C, N]
    prev = jnp.concatenate([prev_theta[:, None], theta[:, :-1]], axis=-1)
    delta = wrap_phase(theta - prev)
    scale = jnp.float32(1.0 / (2.0 * jnp.pi * fd * (1.0 / fs)) * 0.5)
    return theta[:, -1], delta * scale


def fm_discriminate(prev_theta: jnp.ndarray, x: jnp.ndarray, fd: float, fs: float):
    """x: [C, N] complex IQ; prev_theta: [C] carried phase.

    Returns (new_prev_theta [C], y [C, N] float32).
    """
    return fm_discriminate_p(prev_theta, (x.real, x.imag), fd, fs)
