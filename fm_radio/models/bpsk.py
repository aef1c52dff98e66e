"""BPSK symbol synchroniser for the RDS subcarrier.

Parity: ``BPSK_Synchroniser::Process`` (``src/fm_demod/bpsk_synchroniser.cpp:94-186``),
a per-sample loop at Fs_rds = 16 kHz combining:
  * a carrier PLL (PI controller + NCO, ±10 Hz pull) rotating IQ onto the
    imaginary-axis constellation,
  * a zero-crossing detector on Q with a half-symbol trigger cooldown
    (``zero_crossing_detector.cpp``, ``trigger_cooldown.cpp``),
  * a voltage-controlled TED ramp clock (f_center = 2 kHz, ±1.5 kHz pull,
    ``ted_clock.cpp:13-44``) that fires the integrate-&-dump filter,
  * symbol-phase error vs the ±j constellation fed back to the carrier PLL.

Formulation: ``lax.scan`` over the block's samples with a 13-scalar carry,
batched over channels (the reference and debug-tap path; the GPU kernel is
``kernels/bpsk_pallas.py``).  The reference emits a *variable* number of
symbols per block (``bpsk_synchroniser.cpp:94``); under XLA shapes are static,
so we emit per-sample ``(symbol, valid)`` pairs — a symbol is valid on samples
where the TED clock fired.  Downstream consumers compact with the mask.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from fm_radio.config import BPSKConfig
from fm_radio.ops.cmath import chebyshev_sine, wrap_cycles
from fm_radio.ops.design import create_iir_single_pole_lpf


class BPSKParams(NamedTuple):
    ts: jnp.ndarray
    # carrier PLL
    pll_ki_ts: jnp.ndarray
    pll_kp: jnp.ndarray
    pll_f_gain: jnp.ndarray
    pll_lpf_b0: jnp.ndarray
    pll_lpf_a1: jnp.ndarray
    # TED
    ted_ki_ts: jnp.ndarray
    ted_kp: jnp.ndarray
    ted_f_center: jnp.ndarray
    ted_f_gain: jnp.ndarray
    ted_lpf_b0: jnp.ndarray
    ted_lpf_a1: jnp.ndarray
    # integrate & dump
    int_dump_kts: jnp.ndarray
    zcd_cooldown: jnp.ndarray  # int32


class BPSKState(NamedTuple):
    """All [C]-shaped; ints are int32, IQ accumulator complex64."""

    pll_lpf_x1: jnp.ndarray
    pll_lpf_y1: jnp.ndarray
    pll_integ: jnp.ndarray
    pll_nco_t: jnp.ndarray
    pll_prev_pe: jnp.ndarray
    zcd_prev_q: jnp.ndarray
    cooldown: jnp.ndarray      # int32 samples remaining
    ted_lpf_x1: jnp.ndarray
    ted_lpf_y1: jnp.ndarray
    ted_integ: jnp.ndarray
    ted_prev_pe: jnp.ndarray
    ted_ramp: jnp.ndarray      # TED clock integrator voltage
    int_dump: jnp.ndarray      # complex64 accumulator


def bpsk_init_state(channels: int) -> BPSKState:
    z = jnp.zeros((channels,), jnp.float32)
    zi = jnp.zeros((channels,), jnp.int32)
    zc = jnp.zeros((channels,), jnp.complex64)
    return BPSKState(z, z, z, z, z, z, zi, z, z, z, z, z, zc)


def make_bpsk_params(cfg: BPSKConfig) -> BPSKParams:
    fs = cfg.f_sample_rate
    ts = 1.0 / fs
    # loop filters (bpsk_synchroniser.cpp:28-50)
    ted_b, ted_a = create_iir_single_pole_lpf(cfg.ted_max_freq_offset / (fs / 2.0))
    pll_b, pll_a = create_iir_single_pole_lpf(cfg.pll_max_freq_offset / (fs / 2.0))
    # PI gain scaled by symbol/sample ratio (bpsk_synchroniser.cpp:80-90)
    k = cfg.f_symbol_rate / fs
    sps = cfg.samples_per_symbol
    area = 0.5 * sps * 1.0  # triangle area normalization (bpsk_synchroniser.cpp:62-66)
    return BPSKParams(
        ts=jnp.float32(ts),
        pll_ki_ts=jnp.float32(cfg.pll_integrator_gain * ts * k),
        pll_kp=jnp.float32(cfg.pll_proportional_gain),
        pll_f_gain=jnp.float32(cfg.pll_max_freq_offset),
        pll_lpf_b0=jnp.float32(pll_b[0]),
        pll_lpf_a1=jnp.float32(pll_a[1]),
        ted_ki_ts=jnp.float32(cfg.ted_integrator_gain * ts * k),
        ted_kp=jnp.float32(cfg.ted_proportional_gain),
        ted_f_center=jnp.float32(cfg.f_symbol_rate),
        ted_f_gain=jnp.float32(cfg.ted_max_freq_offset),
        ted_lpf_b0=jnp.float32(ted_b[0]),
        ted_lpf_a1=jnp.float32(ted_a[1]),
        int_dump_kts=jnp.float32(1.0 / area),
        # stored f32 like every other loop constant; cast to int32 inside
        # the traced scan
        zcd_cooldown=jnp.float32(cfg.zcd_cooldown),
    )


def bpsk_sync_scan(params: BPSKParams, state: BPSKState, x: jnp.ndarray,
                   debug_taps: bool = False):
    """x: [C, N] complex64 (AGC'd RDS baseband at 16 kHz).

    Returns (state', outs) with outs a dict of [C, N] arrays:
      sym      complex symbol dumped at this sample (0 where invalid)
      valid    bool, TED clock fired here (int_dump_trigger_buf tap)
      pred     float predicted soft symbol (sym.imag, broadcast_fm_demod.cpp:542-546)
      iq       carrier-PLL-rotated input (pll_sym_buf tap)
    With ``debug_taps=True`` the remaining six reference debug buffers
    (``bpsk_synchroniser.h:63-70``) are emitted too: zcd_trig,
    ted_raw_phase_error, ted_pi_phase_error, pll_raw_phase_error,
    pll_pi_phase_error, int_dump_filter.
    """
    one = jnp.float32(1.0)
    half_pi = jnp.float32(jnp.pi / 2.0)
    zcd_cooldown_i = params.zcd_cooldown.astype(jnp.int32)

    def step(c: BPSKState, x_t):
        # --- carrier PLL PI (bpsk_synchroniser.cpp:105-126) ---
        pll_lpf = params.pll_lpf_b0 * (c.pll_prev_pe + c.pll_lpf_x1) - params.pll_lpf_a1 * c.pll_lpf_y1
        pll_integ = jnp.clip(c.pll_integ + params.pll_ki_ts * c.pll_prev_pe, -one, one)
        pi_pll = pll_lpf * params.pll_kp + pll_integ
        control = jnp.clip(pi_pll, -one, one)
        freq = control * params.pll_f_gain  # f_center = 0
        t = wrap_cycles(c.pll_nco_t + params.ts * freq)
        dt_cos = wrap_cycles(t + jnp.float32(0.25))
        pll = jax.lax.complex(chebyshev_sine(dt_cos), chebyshev_sine(t))
        iq = x_t * pll

        # --- zero-crossing detector + cooldown (cpp:128-133) ---
        q = iq.imag
        raw_zcd = (q * c.zcd_prev_q) < 0.0
        fire_zcd = raw_zcd & (c.cooldown == 0)
        # trigger_cooldown.cpp:4-13: set on fire (no decrement that sample),
        # else decrement if pending
        cooldown = jnp.where(
            fire_zcd, zcd_cooldown_i, jnp.maximum(c.cooldown - 1, 0)
        )
        # on zcd: sample the TED clock's timing error (cpp:131-133)
        timing = 2.0 * c.ted_ramp
        timing_err = jnp.where(timing > one, timing - 2.0, timing)
        ted_pe = jnp.where(fire_zcd, timing_err, c.ted_prev_pe)

        # --- TED PI controller (cpp:135-145) ---
        ted_lpf = params.ted_lpf_b0 * (ted_pe + c.ted_lpf_x1) - params.ted_lpf_a1 * c.ted_lpf_y1
        ted_integ = jnp.clip(c.ted_integ + params.ted_ki_ts * ted_pe, -one, one)
        pi_ted = params.ted_kp * ted_lpf + ted_integ

        # --- integrate & dump accumulate (cpp:147-148) ---
        int_dump = c.int_dump + params.int_dump_kts * iq

        # --- TED ramp clock update (ted_clock.cpp:28-44); phase_error = -PI ---
        ted_control = jnp.clip(-pi_ted, -one, one)
        ted_freq = params.ted_f_center + ted_control * params.ted_f_gain
        v = c.ted_ramp + params.ts * ted_freq
        offset = params.ts * ted_freq * 0.5  # finite-sample compensation
        fire_ted = v >= (one - offset)
        ramp = jnp.where(fire_ted, jnp.float32(0.0), v)

        # --- dump (cpp:151-176) ---
        sym = int_dump
        int_dump = jnp.where(fire_ted, jnp.complex64(0.0), int_dump)
        sym_phase = jnp.arctan2(sym.imag, sym.real)
        est_pe = jnp.where(sym_phase > 0.0, half_pi - sym_phase, -half_pi - sym_phase)
        norm_pe = est_pe / half_pi
        pll_pe = jnp.where(fire_ted, norm_pe, c.pll_prev_pe)

        new_c = BPSKState(
            pll_lpf_x1=c.pll_prev_pe,
            pll_lpf_y1=pll_lpf,
            pll_integ=pll_integ,
            pll_nco_t=t,
            pll_prev_pe=pll_pe,
            zcd_prev_q=q,
            cooldown=cooldown,
            ted_lpf_x1=ted_pe,
            ted_lpf_y1=ted_lpf,
            ted_integ=ted_integ,
            ted_prev_pe=ted_pe,
            ted_ramp=ramp,
            int_dump=int_dump,
        )
        out_sym = jnp.where(fire_ted, sym, jnp.complex64(0.0))
        ys = (out_sym, fire_ted, iq)
        if debug_taps:
            ys = ys + (fire_zcd, ted_pe, pi_ted, pll_pe, pi_pll, int_dump)
        return new_c, ys

    new_state, ys = jax.lax.scan(step, state, x.T)
    sym, valid, iq = ys[:3]
    outs = {
        "sym": sym.T,
        "valid": valid.T,
        "pred": sym.T.imag,
        "iq": iq.T,
    }
    if debug_taps:
        (outs["zcd_trig"], outs["ted_raw_phase_error"],
         outs["ted_pi_phase_error"], outs["pll_raw_phase_error"],
         outs["pll_pi_phase_error"], outs["int_dump_filter"]) = (
            y.T for y in ys[3:]
        )
    return new_state, outs
