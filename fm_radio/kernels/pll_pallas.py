"""Pallas (Triton) kernel for the 19 kHz pilot PLL.

Same recurrence as :func:`fm_radio.models.pilot_pll.pilot_pll_scan`
(parity: ``broadcast_fm_demod.cpp:418-456``), but the whole per-sample loop
is ONE GPU kernel instead of one XLA launch per step:

- one program per channel tile of ``bc`` channels (one thread per channel,
  one warp per program); the 5-scalar loop carry stays in registers;
- the time loop is a ``lax.fori_loop`` inside the program;
- the input is time-major ``[N, C]`` so each step reads one contiguous row
  of the tile (coalesced), and ``UNROLL`` rows are loaded together at the
  top of each loop iteration so their memory latency overlaps instead of
  stalling every serial step.

Loop constants enter as Python floats (static), so a config change
recompiles — same policy as the jit-static ``DemodConfig``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_STATE_ROWS = 5  # lpf_x1, lpf_y1, integ, nco_t, prev_pe

# Channels per program: one warp, one channel per thread.  The loops are
# latency-bound (each step depends on the last), so wider tiles only add
# registers; channel counts above this spread over more programs/SMs.
MAX_TILE = 32
# Rows loaded per loop iteration (memory-latency hiding, see module doc).
UNROLL = 16


def _wrap(t):
    """Wrap to [-0.5, +0.5] cycles.  ``t - floor(t + 0.5)``: the same wrap
    as ``ops/cmath.wrap_cycles`` (which rounds half-to-even) except at exact
    ties; Triton has no round primitive."""
    return t - jnp.floor(t + jnp.float32(0.5))


def pick_channel_tile(c: int) -> tuple[int, int]:
    """(tile width, padded channel count) for ``c`` channels.

    The tile is the smallest power of two >= c, capped at MAX_TILE (Triton
    blocks must be powers of two); the channel axis is zero-padded up to a
    multiple of it, so every program reads and writes whole rows and any c
    (including 1 and non-powers of two) works without masks."""
    bc = 1
    while bc < min(c, MAX_TILE):
        bc *= 2
    return bc, -(-c // bc) * bc


def pad_channels(x: jnp.ndarray, c_pad: int) -> jnp.ndarray:
    """Zero-pad the trailing (channel) axis of ``x`` to ``c_pad``."""
    extra = c_pad - x.shape[-1]
    if extra == 0:
        return x
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, extra)])


def serial_loop(step, n: int, carry, load, store, unroll: int = UNROLL):
    """Run ``step`` over n time steps inside a kernel program.

    ``load(i)`` returns step i's inputs, ``step(carry, inputs)`` returns
    ``(carry', outputs)`` and ``store(i, outputs)`` writes them.  The first
    ``n // unroll * unroll`` steps load ``unroll`` rows at a time before
    computing them; the remainder runs one step per iteration."""

    def block(k, carry):
        base = k * unroll
        rows = [load(base + u) for u in range(unroll)]
        for u in range(unroll):
            carry, out = step(carry, rows[u])
            store(base + u, out)
        return carry

    def single(i, carry):
        carry, out = step(carry, load(i))
        store(i, out)
        return carry

    n_blk = n // unroll
    if n_blk:
        carry = jax.lax.fori_loop(0, n_blk, block, carry)
    if n - n_blk * unroll:
        carry = jax.lax.fori_loop(n_blk * unroll, n, single, carry)
    return carry


def _pll_kernel(theta_ref, st_ref, dt_ref, out_st_ref, *, n_steps: int,
                bc: int, ts: float, f_center: float, f_gain: float,
                ki_ts: float, kp: float, lpf_b0: float, lpf_a1: float):
    """Serial PI+NCO loop over precomputed pilot phase angles (cycles).

    The reference rotates the pilot by the NCO phasor and measures
    atan2(Im, Re) of the product (broadcast_fm_demod.cpp:430-456).  Since
    atan2(x * e^{j2pi t}) = wrap_pi(angle(x) + 2pi t), the angle(x) part is
    data-parallel and computed OUTSIDE the kernel; the serial chain keeps
    only the loop filter + NCO + one wrap.
    """
    one = jnp.float32(1.0)
    two_pi = jnp.float32(2.0 * jnp.pi)
    cols = pl.ds(pl.program_id(0) * bc, bc)

    def step(carry, th):
        lpf_x1, lpf_y1, integ, nco_t, prev_pe = carry
        lpf_pe = jnp.float32(lpf_b0) * (prev_pe + lpf_x1) \
            - jnp.float32(lpf_a1) * lpf_y1
        integ = jnp.clip(integ + jnp.float32(ki_ts) * prev_pe, -one, one)
        control = jnp.clip(lpf_pe * jnp.float32(kp) + integ, -one, one)
        t = _wrap(nco_t + jnp.float32(ts) * (
            jnp.float32(f_center) + control * jnp.float32(f_gain)))
        pe = two_pi * _wrap(th + t)
        return (prev_pe, lpf_pe, integ, t, pe), t

    def store(i, t):
        dt_ref[i, cols] = t

    carry0 = tuple(st_ref[k, cols] for k in range(_STATE_ROWS))
    final = serial_loop(step, n_steps, carry0, lambda i: theta_ref[i, cols],
                        store)
    for k in range(_STATE_ROWS):
        out_st_ref[k, cols] = final[k]


def pll_consts_from_cfg(cfg) -> dict:
    """Loop constants as Python floats (host-side, cfg-derived — usable as
    static kernel parameters inside a traced demod_block)."""
    from fm_radio.ops.design import create_iir_single_pole_lpf

    r = cfg.rates
    ts = 1.0 / float(r.fs_fm_out)
    k_lpf = cfg.analog.f_pilot_deviation / (r.fs_fm_out / 2.0)
    lpf_b, lpf_a = create_iir_single_pole_lpf(k_lpf)
    return dict(
        ts=ts,
        f_center=-float(cfg.analog.f_pilot),
        f_gain=-float(cfg.analog.f_pilot_deviation),
        ki_ts=cfg.pilot_pll_integrator_gain * ts,
        kp=cfg.pilot_pll_proportional_gain,
        lpf_b0=float(lpf_b[0]),
        lpf_a1=float(lpf_a[1]),
    )


def pll_loop_pallas(cfg, st_rows: jnp.ndarray, theta_t: jnp.ndarray,
                    interpret: bool = False):
    """The raw kernel call: st_rows [5, C], theta_t [N, C] time-major
    (cycles).  Returns (dt_t [N, C], st_rows' [5, C])."""
    n, c = theta_t.shape
    bc, c_pad = pick_channel_tile(c)
    kern = functools.partial(_pll_kernel, n_steps=n, bc=bc,
                             **pll_consts_from_cfg(cfg))
    dt_t, out_st = pl.pallas_call(
        kern,
        grid=(c_pad // bc,),
        out_shape=[
            jax.ShapeDtypeStruct((n, c_pad), jnp.float32),
            jax.ShapeDtypeStruct((_STATE_ROWS, c_pad), jnp.float32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="pilot_pll",
    )(pad_channels(theta_t, c_pad), pad_channels(st_rows, c_pad))
    return dt_t[:, :c], out_st[:, :c]


def _state_rows(state) -> jnp.ndarray:
    return jnp.stack(
        [state.lpf_x1, state.lpf_y1, state.integ, state.nco_t, state.prev_pe]
    )


def _rows_state(rows: jnp.ndarray):
    # imported here: models/ imports this module (models/demod.py)
    from fm_radio.models.pilot_pll import PilotPLLState

    return PilotPLLState(lpf_x1=rows[0], lpf_y1=rows[1], integ=rows[2],
                         nco_t=rows[3], prev_pe=rows[4])


def pilot_pll_pallas(cfg, state, pilot, interpret: bool = False):
    """Drop-in for pilot_pll_scan's production output.

    pilot: [C, N] complex64 or a plane tuple (re, im) of f32 [C, N].
    Returns (state', dt [C, N] f32).  (The debug taps pll/raw_pe/pi_pe are
    only produced by the scan path.)

    With ``cfg.pll_time_chunks > 1`` the block's serial loop is split into
    G time chunks that ride the channel axis (:func:`_pilot_pll_chunked`).
    """
    pr, pi = pilot if isinstance(pilot, tuple) else (pilot.real, pilot.imag)
    # data-parallel part of the phase detector: angle(pilot) in cycles
    theta_cn = jnp.arctan2(pi, pr) * jnp.float32(1.0 / (2.0 * jnp.pi))
    if cfg.pll_time_chunks > 1:
        return _pilot_pll_chunked(cfg, state, theta_cn, interpret=interpret)
    dt_t, rows = pll_loop_pallas(cfg, _state_rows(state), theta_cn.T,
                                 interpret=interpret)
    return _rows_state(rows), dt_t.T


def check_time_chunks(cfg, n: int) -> None:
    """Reject a ``pll_time_chunks`` setting the block length cannot honour
    (rather than silently running the sequential loop)."""
    g, w = int(cfg.pll_time_chunks), int(cfg.pll_chunk_warmup)
    if g > 1 and (n % g or n // g <= w):
        raise ValueError(
            f"pll_time_chunks={g} needs the PLL block length ({n} samples at "
            f"fs_fm_out) divisible by {g} with chunks longer than "
            f"pll_chunk_warmup={w}")


def _pilot_pll_chunked(cfg, state, theta_cn: jnp.ndarray,
                       interpret: bool = False):
    """Block-parallel PLL (SURVEY.md §7 "the hard parts"): the N-step serial
    loop is split into G time chunks processed SIMULTANEOUSLY as extra
    channels of one kernel call (C*G channels, N/G + W steps).

    Soundness: the pilot PLL is an *observer* of a strong 19 kHz tone — every
    locked state tracks the same NCO phase trajectory, so a chunk that starts
    from an approximate state converges to the sequential dt within the
    warm-up W (loop bandwidth ~100 Hz at Fs=128 kHz: phase re-acquires in
    ~1-2k samples).  Chunk 0 starts from the TRUE carried state with no
    warm-up (bit-exact stream head); chunks 1..G-1 start from the replicated
    entry state (already near lock in streaming steady state) and their first
    W outputs are discarded in favor of the left chunk's tail.  The block's
    carried-out state comes from the last chunk, so the next block continues
    from a locked state exactly as the sequential path would.

    Cost: (N/G + W) serial steps instead of N.  It pays off where channels
    are few (single-station latency: C=1), not in batch throughput, where
    the channel axis already fills the card.

    Accuracy: chunk 0 is exact; later chunks agree with the sequential dt to
    ~3e-3 cycles rms (the loops see identical inputs from slightly different
    states; the difference decays with the proportional time constant
    1/(2*pi*f_dev*Kp) ~ 20k samples, longer than a chunk).  RDS hard
    decisions are unchanged; audio differs from the sequential path at the
    -35 dB level — a scanning/monitoring trade, which is why the default is
    pll_time_chunks=1 (exact).
    """
    c, n = theta_cn.shape
    check_time_chunks(cfg, n)
    g = int(cfg.pll_time_chunks)
    w = int(cfg.pll_chunk_warmup)
    l = n // g

    # chunk g input: theta[gL - W : gL + L] (chunk 0: [0 : L + W], no warmup)
    starts = [max(gg * l - w, 0) for gg in range(g)]
    xw = jnp.concatenate(
        [jax.lax.dynamic_slice_in_dim(theta_cn, s, l + w, axis=1) for s in starts]
    )  # [G*C, L+W] chunk-major

    # Initial states: chunk 0 true; chunks 1..G-1 replicate the entry state
    # (loop-filter + integrator carry the frequency information) but seed the
    # NCO phase FROM THE SIGNAL: a locked loop satisfies t = -theta (mod 1),
    # so nco_t = -theta[start] - ts*f_center makes the first phase error ~
    # loop-noise sized instead of uniformly random.  With the proportional
    # time constant at 1/(2*pi*f_dev*Kp) ~ 20k samples, seeding is what makes
    # a short warm-up sufficient.  The integrator (frequency memory) is
    # deliberately NOT re-seeded from a local frequency estimate: any
    # estimate error would become a persistent frequency offset.
    consts = pll_consts_from_cfg(cfg)
    st_all = jnp.tile(_state_rows(state), (1, g))  # [5, G*C]
    seed_t = jnp.concatenate(
        [state.nco_t]
        + [-theta_cn[:, s] - jnp.float32(consts["ts"] * consts["f_center"])
           for s in starts[1:]]
    )
    seed_t = seed_t - jnp.round(seed_t)
    st_all = st_all.at[3, :].set(seed_t)

    dt_t, out_st = pll_loop_pallas(cfg, st_all, xw.T, interpret=interpret)
    dt_all = dt_t.T.reshape(g, c, l + w)
    # keep the payload [gL, gL+L) of each chunk: offset gL - start into its dt
    dt = jnp.concatenate(
        [jax.lax.dynamic_slice_in_dim(dt_all[gg], gg * l - starts[gg], l, axis=1)
         for gg in range(g)],
        axis=1,
    )
    # carried-out state: the LAST chunk's — its input ends exactly at sample N
    return _rows_state(out_st[:, (g - 1) * c:]), dt
