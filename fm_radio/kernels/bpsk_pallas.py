"""Pallas (Triton) kernel for the BPSK symbol synchroniser.

Same recurrence as :func:`fm_radio.models.bpsk.bpsk_sync_scan`
(parity: ``bpsk_synchroniser.cpp:94-186``) as one GPU kernel: carrier PLL,
zero-crossing detector with cooldown, TED ramp clock, integrate-&-dump.
Layout and loop structure are those of the pilot-PLL kernel
(``kernels/pll_pallas.py``): one program per channel tile, the 14-scalar
carry in registers, time-major ``[N, C]`` rows read ``UNROLL`` at a time.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from fm_radio.kernels.pll_pallas import (
    _wrap,
    pad_channels,
    pick_channel_tile,
    serial_loop,
)
from fm_radio.ops.cmath import chebyshev_sine

_ROWS = 14  # see _pack_state


def _pack_state(s) -> jnp.ndarray:
    return jnp.stack(
        [
            s.pll_lpf_x1, s.pll_lpf_y1, s.pll_integ, s.pll_nco_t, s.pll_prev_pe,
            s.zcd_prev_q, s.cooldown.astype(jnp.float32),
            s.ted_lpf_x1, s.ted_lpf_y1, s.ted_integ, s.ted_prev_pe, s.ted_ramp,
            jnp.real(s.int_dump), jnp.imag(s.int_dump),
        ]
    )


def _unpack_state(st: jnp.ndarray):
    # imported here: models/ imports this module (models/demod.py)
    from fm_radio.models.bpsk import BPSKState

    return BPSKState(
        pll_lpf_x1=st[0], pll_lpf_y1=st[1], pll_integ=st[2], pll_nco_t=st[3],
        pll_prev_pe=st[4], zcd_prev_q=st[5], cooldown=st[6].astype(jnp.int32),
        ted_lpf_x1=st[7], ted_lpf_y1=st[8], ted_integ=st[9], ted_prev_pe=st[10],
        ted_ramp=st[11], int_dump=jax.lax.complex(st[12], st[13]),
    )


def _bpsk_kernel(
    x_re_ref, x_im_ref, st_ref, pred_ref, sym_re_ref, valid_ref, out_st_ref,
    *, n_steps: int, bc: int, ts: float, pll_ki_ts: float, pll_kp: float,
    pll_f_gain: float, pll_lpf_b0: float, pll_lpf_a1: float, ted_ki_ts: float,
    ted_kp: float, ted_f_center: float, ted_f_gain: float, ted_lpf_b0: float,
    ted_lpf_a1: float, int_dump_kts: float, zcd_cooldown: float,
):
    one = jnp.float32(1.0)
    zero = jnp.float32(0.0)
    half_pi = jnp.float32(jnp.pi / 2.0)
    ts_f = jnp.float32(ts)
    cols = pl.ds(pl.program_id(0) * bc, bc)

    def step(carry, x):
        (p_x1, p_y1, p_int, p_t, p_pe, zq, cool,
         t_x1, t_y1, t_int, t_pe, ramp, id_re, id_im) = carry
        xr, xi = x

        # carrier PLL PI + NCO
        p_lpf = jnp.float32(pll_lpf_b0) * (p_pe + p_x1) \
            - jnp.float32(pll_lpf_a1) * p_y1
        p_int2 = jnp.clip(p_int + jnp.float32(pll_ki_ts) * p_pe, -one, one)
        control = jnp.clip(p_lpf * jnp.float32(pll_kp) + p_int2, -one, one)
        t = _wrap(p_t + ts_f * (control * jnp.float32(pll_f_gain)))
        c = chebyshev_sine(_wrap(t + jnp.float32(0.25)))
        s = chebyshev_sine(t)
        iq_re = xr * c - xi * s
        iq_im = xr * s + xi * c

        # zero-crossing detector + cooldown
        fire_zcd = ((iq_im * zq) < zero) & (cool == zero)
        cool2 = jnp.where(
            fire_zcd, jnp.float32(zcd_cooldown), jnp.maximum(cool - one, zero)
        )
        timing = jnp.float32(2.0) * ramp
        timing_err = jnp.where(timing > one, timing - jnp.float32(2.0), timing)
        t_pe2 = jnp.where(fire_zcd, timing_err, t_pe)

        # TED PI
        t_lpf = jnp.float32(ted_lpf_b0) * (t_pe2 + t_x1) \
            - jnp.float32(ted_lpf_a1) * t_y1
        t_int2 = jnp.clip(t_int + jnp.float32(ted_ki_ts) * t_pe2, -one, one)
        pi_ted = jnp.float32(ted_kp) * t_lpf + t_int2

        # integrate & dump
        id_re2 = id_re + jnp.float32(int_dump_kts) * iq_re
        id_im2 = id_im + jnp.float32(int_dump_kts) * iq_im

        # TED ramp clock
        tfreq = jnp.float32(ted_f_center) \
            + jnp.clip(-pi_ted, -one, one) * jnp.float32(ted_f_gain)
        v = ramp + ts_f * tfreq
        fire_ted = v >= (one - ts_f * tfreq * jnp.float32(0.5))
        ramp2 = jnp.where(fire_ted, zero, v)

        # dump
        sym_phase = jnp.arctan2(id_im2, id_re2)
        est_pe = jnp.where(sym_phase > zero, half_pi - sym_phase,
                           -half_pi - sym_phase)
        p_pe2 = jnp.where(fire_ted, est_pe / half_pi, p_pe)

        fire_f = fire_ted.astype(jnp.float32)
        out = (id_im2 * fire_f, id_re2 * fire_f, fire_f)
        new = (p_pe, p_lpf, p_int2, t, p_pe2, iq_im, cool2,
               t_pe2, t_lpf, t_int2, t_pe2, ramp2,
               jnp.where(fire_ted, zero, id_re2),
               jnp.where(fire_ted, zero, id_im2))
        return new, out

    def load(i):
        return x_re_ref[i, cols], x_im_ref[i, cols]

    def store(i, out):
        pred_ref[i, cols], sym_re_ref[i, cols], valid_ref[i, cols] = out

    carry0 = tuple(st_ref[k, cols] for k in range(_ROWS))
    final = serial_loop(step, n_steps, carry0, load, store)
    for k in range(_ROWS):
        out_st_ref[k, cols] = final[k]


def bpsk_consts_from_cfg(cfg) -> dict:
    """Static kernel constants from the hashable DemodConfig."""
    from fm_radio.ops.design import create_iir_single_pole_lpf

    b = cfg.bpsk
    fs = b.f_sample_rate
    ts = 1.0 / fs
    ted_b, ted_a = create_iir_single_pole_lpf(b.ted_max_freq_offset / (fs / 2.0))
    pll_b, pll_a = create_iir_single_pole_lpf(b.pll_max_freq_offset / (fs / 2.0))
    k = b.f_symbol_rate / fs
    area = 0.5 * b.samples_per_symbol
    return dict(
        ts=ts,
        pll_ki_ts=b.pll_integrator_gain * ts * k,
        pll_kp=b.pll_proportional_gain,
        pll_f_gain=b.pll_max_freq_offset,
        pll_lpf_b0=float(pll_b[0]),
        pll_lpf_a1=float(pll_a[1]),
        ted_ki_ts=b.ted_integrator_gain * ts * k,
        ted_kp=b.ted_proportional_gain,
        ted_f_center=b.f_symbol_rate,
        ted_f_gain=b.ted_max_freq_offset,
        ted_lpf_b0=float(ted_b[0]),
        ted_lpf_a1=float(ted_a[1]),
        int_dump_kts=1.0 / area,
        zcd_cooldown=float(b.zcd_cooldown),
    )


def bpsk_sync_pallas(cfg, state, x, interpret: bool = False):
    """Drop-in for bpsk_sync_scan's production outputs.

    x: [C, N] complex64 or a plane tuple (re, im) of f32 [C, N].
    Returns (state', outs) with outs keys sym / pred / valid (the iq debug
    tap is scan-path only).
    """
    xr, xi = x if isinstance(x, tuple) else (x.real, x.imag)
    c, n = xr.shape
    bc, c_pad = pick_channel_tile(c)
    kern = functools.partial(_bpsk_kernel, n_steps=n, bc=bc,
                             **bpsk_consts_from_cfg(cfg))
    io = jax.ShapeDtypeStruct((n, c_pad), jnp.float32)
    pred_t, sym_re_t, valid_t, out_st = pl.pallas_call(
        kern,
        grid=(c_pad // bc,),
        out_shape=[io, io, io,
                   jax.ShapeDtypeStruct((_ROWS, c_pad), jnp.float32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="bpsk_sync",
    )(pad_channels(xr.T, c_pad), pad_channels(xi.T, c_pad),
      pad_channels(_pack_state(state), c_pad))

    pred, sym_re = pred_t[:, :c].T, sym_re_t[:, :c].T
    outs = {
        "sym": jax.lax.complex(sym_re, pred),
        "pred": pred,
        "valid": valid_t[:, :c].T > 0.5,
    }
    return _unpack_state(out_st[:, :c]), outs
