"""Harmonic PLL mixer: y[n] = x[n] * exp(j*2*pi*(dt[n]*harmonic + offset)).

Parity: ``apply_harmonic_pll_scalar`` (``src/dsp/simd/apply_harmonic_pll.cpp:11-24``)
— used to downconvert the 38 kHz L-R band (harmonic=2) and the 57 kHz RDS band
(harmonic=3) using the pilot NCO phase track ``dt`` (in cycles,
``broadcast_fm_demod.cpp:485-531``).

Note: the reference passes the L-R phase-correction ``offset`` (estimated in
radians at ``broadcast_fm_demod.cpp:496-517``) directly into the cycle-domain
phase here; we replicate that behavior exactly for parity.

This is a pure vector op (5-FMA Chebyshev phasor + complex multiply) that XLA
fuses with the following polyphase decimator's input stage.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from fm_radio.ops.cmath import chebyshev_sine, wrap_cycles


def apply_harmonic_pll_p(dt: jnp.ndarray, xp, harmonic: float, offset):
    """Plane-tuple variant: xp = (re, im) f32. Returns (yr, yi)."""
    offset = jnp.asarray(offset, jnp.float32)
    if offset.ndim == 1:
        offset = offset[:, None]
    xr, xi = xp
    dt_sin = dt * jnp.float32(harmonic) + offset
    dt_cos = wrap_cycles(dt_sin + jnp.float32(0.25))
    dt_sin = wrap_cycles(dt_sin)
    c = chebyshev_sine(dt_cos)
    s = chebyshev_sine(dt_sin)
    return xr * c - xi * s, xr * s + xi * c


def apply_harmonic_pll(dt: jnp.ndarray, x: jnp.ndarray, harmonic: float, offset):
    """dt: [C, N] NCO phase in cycles; x: [C, N] complex; offset: scalar or [C]."""
    yr, yi = apply_harmonic_pll_p(dt, (x.real, x.imag), harmonic, offset)
    return jax.lax.complex(yr, yi)


def freq_shift_p(phase0, xp, f_norm: float):
    """Arbitrary-frequency complex downconversion with carried phase.

    Parity: the role of the RTL-SDR tuner's center-frequency retune
    (``device.cpp:74-83``) for recorded wideband captures — shift a station
    at normalized frequency ``f_norm`` (cycles/sample) to DC:
    ``y[n] = x[n] * e^{-j*2*pi*(f_norm*n + phase0)}``.

    phase0: [C] carried phase in cycles (stream-continuous across blocks);
    xp: (re, im) f32 [C, N].  Returns (phase0', (yr, yi)).
    """
    import numpy as np

    xr, xi = xp
    n = xr.shape[-1]
    # f_norm is static: build the wrapped ramp in float64 on host (an f32
    # ramp loses ~1e-4 cycles by n ~ 1000; wrapped f64 keeps it < 1e-7)
    ramp = np.mod(np.float64(f_norm) * np.arange(n), 1.0).astype(np.float32)
    ph = wrap_cycles(jnp.asarray(phase0, jnp.float32)[:, None] + ramp[None, :])
    c = chebyshev_sine(wrap_cycles(ph + jnp.float32(0.25)))
    s = chebyshev_sine(ph)
    # e^{-j 2 pi ph} = c - j s
    yr = xr * c + xi * s
    yi = xi * c - xr * s
    new_phase = jnp.asarray(phase0, jnp.float32) + jnp.float32(
        np.mod(np.float64(f_norm) * n, 1.0)
    )
    return new_phase - jnp.round(new_phase), (yr, yi)
