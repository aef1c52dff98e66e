"""Scalar/vector math helpers shared by the demod loops.

``chebyshev_sine`` reproduces the reference's 6-coefficient Chebyshev
approximation of sin(2*pi*x) on [-0.5, +0.5] (``src/dsp/simd/chebyshev_sine.h:13-46``,
MAE 3.63e-8).  We keep the same polynomial rather than ``jnp.sin`` both for
bit-level parity with the reference's NCO phasors and because a 5-FMA
polynomial is cheaper than a transcendental inside the serial loops.
"""

from __future__ import annotations

import jax.numpy as jnp

# chebyshev_sine.h:13-20
_CHEB = (
    -25.13274193,
    64.83583069,
    -67.07687378,
    38.50016403,
    -14.07150173,
    3.20396066,
)


def chebyshev_sine(x):
    """sin(2*pi*x) for x in [-0.5, +0.5] via Chebyshev polynomial (Horner)."""
    a0, a1, a2, a3, a4, a5 = (jnp.float32(c) for c in _CHEB)
    z = x * x
    b = a5
    b = b * z + a4
    b = b * z + a3
    b = b * z + a2
    b = b * z + a1
    b = b * z + a0
    return b * (z - jnp.float32(0.25)) * x


def wrap_cycles(t):
    """Wrap to [-0.5, +0.5] cycles: t - round(t) (``pll_mixer.cpp:18``)."""
    return t - jnp.round(t)


def cheb_phasor(dt):
    """exp(j*2*pi*dt) as (cos, sin) via chebyshev_sine, dt in cycles.

    Matches the NCO phasor construction at ``broadcast_fm_demod.cpp:441-445``:
    sin part from dt, cos part from wrap(dt + 0.25).
    """
    dt_sin = wrap_cycles(dt)
    dt_cos = wrap_cycles(dt_sin + jnp.float32(0.25))
    return chebyshev_sine(dt_cos), chebyshev_sine(dt_sin)


def wrap_phase(x):
    """Wrap one turn into (-pi, pi]: single-branch wrap like
    ``fm_demod.cpp:6-10`` (assumes |x| < 3*pi, true for phase differences)."""
    pi = jnp.float32(jnp.pi)
    two_pi = jnp.float32(2.0 * jnp.pi)
    x = jnp.where(x >= pi, x - two_pi, x)
    x = jnp.where(x <= -pi, x + two_pi, x)
    return x
