"""19 kHz stereo-pilot phase-locked loop.

Parity: the per-sample PI + NCO loop at ``broadcast_fm_demod.cpp:418-456``:

    for each sample i (at Fs_fm_out = 128 kHz):
        lpf_pe   = IIR1_lpf(prev_pe)                     # 100 Hz loop filter
        integ    = clamp(integ + Ki*Ts*prev_pe, -1, 1)   # PI integrator
        PI       = Kp*lpf_pe + integ
        freq     = f_center + clamp(PI, -1, 1) * f_gain  # NCO (PLL_Mixer)
        t        = wrap_cycles(t + Ts*freq)
        pll      = exp(j*2*pi*t)  (Chebyshev phasor)
        prev_pe  = atan2(Im, Re) of pilot[i] * pll

with f_center = -19 kHz, f_gain = -100 Hz (``broadcast_fm_demod.cpp:229-231``),
Ki = 0.1, Kp = 0.01 (``broadcast_fm_demod.h:49-52``).

Formulation: a genuinely nonlinear feedback loop (atan2 of input x NCO), so
the recurrence is a ``lax.scan`` whose carry is 5 scalars *per channel* —
scanning the time axis once with all channels processed in parallel (the
reference and debug-tap path; the GPU kernel is ``kernels/pll_pallas.py``).  The
emitted NCO phase track ``dt`` (cycles) feeds the feed-forward harmonic mixers.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from fm_radio.ops.cmath import chebyshev_sine, wrap_cycles


class PilotPLLParams(NamedTuple):
    ts: jnp.ndarray            # 1/Fs_fm_out
    f_center: jnp.ndarray      # -F_pilot
    f_gain: jnp.ndarray        # -F_pilot_deviation
    ki_ts: jnp.ndarray         # integrator_gain * Ts
    kp: jnp.ndarray            # proportional gain
    lpf_b0: jnp.ndarray        # loop-filter 1-pole LPF coefficients
    lpf_a1: jnp.ndarray


class PilotPLLState(NamedTuple):
    """All [C]-shaped float32."""

    lpf_x1: jnp.ndarray        # loop filter x[n-1]
    lpf_y1: jnp.ndarray        # loop filter y[n-1]
    integ: jnp.ndarray         # clamped PI integrator
    nco_t: jnp.ndarray         # NCO phase (cycles, wrapped)
    prev_pe: jnp.ndarray       # previous raw phase error (rad)


def pilot_pll_init_state(channels: int) -> PilotPLLState:
    z = jnp.zeros((channels,), jnp.float32)
    return PilotPLLState(z, z, z, z, z)


def make_pilot_pll_params(fs_fm_out: float, f_pilot: float, f_pilot_deviation: float,
                          ki: float, kp: float, lpf_b, lpf_a) -> PilotPLLParams:
    ts = 1.0 / float(fs_fm_out)
    return PilotPLLParams(
        ts=jnp.float32(ts),
        f_center=jnp.float32(-f_pilot),
        f_gain=jnp.float32(-f_pilot_deviation),
        ki_ts=jnp.float32(ki * ts),
        kp=jnp.float32(kp),
        lpf_b0=jnp.float32(lpf_b[0]),
        lpf_a1=jnp.float32(lpf_a[1]),
    )


def pilot_pll_scan(params: PilotPLLParams, state: PilotPLLState, pilot: jnp.ndarray):
    """Run the PLL over a block.

    pilot: [C, N] complex64 (peak-filtered + AGC'd pilot band).
    Returns (state', taps) where taps is a dict of [C, N] arrays:
      dt (NCO cycles), pll (complex phasor), raw_pe, pi_pe — matching the
      reference's pll_dt_buf / pll_buf / pll_raw_phase_error /
      pll_lpf_phase_error tap buffers.
    """

    def step(carry: PilotPLLState, x_t):
        # x_t: [C] complex — one time step across channels
        one = jnp.float32(1.0)
        # loop filter: y = b0*(x + x1) - a1*y1 applied to prev_pe
        lpf_pe = params.lpf_b0 * (carry.prev_pe + carry.lpf_x1) - params.lpf_a1 * carry.lpf_y1
        # PI integrator with clamp (broadcast_fm_demod.cpp:434-435)
        integ = jnp.clip(carry.integ + params.ki_ts * carry.prev_pe, -one, one)
        pi_err = lpf_pe * params.kp + integ
        # NCO (pll_mixer.cpp:12-21); phase_error_gain = 1
        control = jnp.clip(pi_err, -one, one)
        freq = params.f_center + control * params.f_gain
        t = wrap_cycles(carry.nco_t + params.ts * freq)
        dt_cos = wrap_cycles(t + jnp.float32(0.25))
        pll = jax.lax.complex(chebyshev_sine(dt_cos), chebyshev_sine(t))
        residual = x_t * pll
        pe = jnp.arctan2(residual.imag, residual.real)
        new_carry = PilotPLLState(
            lpf_x1=carry.prev_pe, lpf_y1=lpf_pe, integ=integ, nco_t=t, prev_pe=pe
        )
        return new_carry, (t, pll, pe, pi_err)

    new_state, (dt, pll, raw_pe, pi_pe) = jax.lax.scan(step, state, pilot.T)
    taps = {
        "dt": dt.T,
        "pll": pll.T,
        "raw_pe": raw_pe.T,
        "pi_pe": pi_pe.T,
    }
    return new_state, taps
