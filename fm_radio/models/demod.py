"""Broadcast-FM demodulator: the flagship channel-batched pipeline.

Parity: ``Broadcast_FM_Demod`` (``src/fm_demod/broadcast_fm_demod.{h,cpp}``),
stage for stage:

    baseband[C, B] c64 @Fs_bb
      -> polyphase ds x4 LPF           -> fm_in      @Fs/4     (cpp:391-393)
      -> FM discriminator              -> fm_demod             (cpp:395-398)
      -> polyphase ds x2 LPF           -> fm_out     @Fs/8     (cpp:400-401)
      -> optional IIR de-emphasis      -> fm_out               (cpp:403-406)
      -> Hilbert FIR (65 taps)         -> fm_out_iq            (cpp:408-410)
      -> IIR peak 19k + AGC + PLL scan -> pll dt track         (cpp:418-456)
      -> ds x4 -> Re                   -> audio_lpr  @Fs/32    (cpp:473-481)
      -> x PLL^2, phase corr, ds x4 -> Im -> audio_lmr         (cpp:483-523)
      -> x PLL^3, ds x8                -> rds        @Fs/64    (cpp:525-535)
      -> AGC + BPSK sync scan          -> rds symbols          (cpp:538-547)
      -> stereo mix x2                 -> audio[C, B/32, 2]    (cpp:549-585)

Everything is a pure function of (coeffs, state, x); ``DemodState`` is the
complete cross-block carry — serializing it gives checkpoint/resume and
time-shard handoff for free (SURVEY.md §5.4/§5.7).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from fm_radio.config import AudioOut, DemodConfig
from fm_radio.kernels.bpsk_pallas import bpsk_sync_pallas
from fm_radio.kernels.pll_pallas import pilot_pll_pallas
from fm_radio.models.bpsk import (
    BPSKParams,
    BPSKState,
    bpsk_init_state,
    bpsk_sync_scan,
    make_bpsk_params,
)
from fm_radio.models.pilot_pll import (
    PilotPLLParams,
    PilotPLLState,
    make_pilot_pll_params,
    pilot_pll_init_state,
    pilot_pll_scan,
)
from fm_radio.ops.agc import agc_init_state, agc_process_p, agc_update_gain
from fm_radio.ops.design import (
    create_fir_hilbert,
    create_fir_lpf,
    create_iir_peak_1_filter,
    create_iir_single_pole_lpf,
)
from fm_radio.ops.discriminator import fm_discriminate_p
from fm_radio.ops.fir import (
    hilbert_fir_p,
    polyphase_decimate,
    polyphase_decimate_p,
)
from fm_radio.ops.iir import iir_filter, iir_filter_planes, iir_init_state
from fm_radio.ops.mixer import apply_harmonic_pll_p
from fm_radio.utils.transfer import i8_planes_to_f32, unpack_iq_words


class DemodCoeffs(NamedTuple):
    """All filter taps + loop constants (host-designed, device-resident)."""

    taps_fm_in: jnp.ndarray       # [64]  ds x4 LPF (c64 path)
    taps_fm_out: jnp.ndarray      # [64]  ds x2 LPF (f32 path)
    taps_hilbert: jnp.ndarray     # [65]
    taps_audio_lpr: jnp.ndarray   # [128] ds x4 LPF
    taps_audio_lmr: jnp.ndarray   # [128] ds x4 LPF
    taps_rds: jnp.ndarray         # [128] ds x8 LPF
    peak_b: jnp.ndarray           # [3] pilot IIR peak
    peak_a: jnp.ndarray
    deemph_b: jnp.ndarray         # [2] de-emphasis single-pole LPF
    deemph_a: jnp.ndarray
    pll: PilotPLLParams
    bpsk: BPSKParams


def make_coeffs(cfg: DemodConfig) -> DemodCoeffs:
    """Design every filter exactly as the reference constructor + UpdateFilters
    do (``broadcast_fm_demod.cpp:127-304,330-389``)."""
    r = cfg.rates
    roll = cfg.downsampling_rolloff_factor

    # NOTE (reference quirk, replicated): the fm_in decimator is sized with
    # order_poly_ds_lpf_fm_out (broadcast_fm_demod.cpp:134).
    k_fm_in = (r.fs_fm_in / 2.0) / (r.fs_baseband / 2.0) * roll
    taps_fm_in = create_fir_lpf(cfg.order_poly_ds_lpf_fm_out, k_fm_in)

    k_fm_out = (r.fs_fm_out / 2.0) / (r.fs_fm_in / 2.0) * roll
    taps_fm_out = create_fir_lpf(cfg.order_poly_ds_lpf_fm_out, k_fm_out)

    taps_hilbert = create_fir_hilbert(cfg.order_fir_hilbert)

    taps_audio_lpr = create_fir_lpf(cfg.order_poly_ds_lpf_audio, cfg.k_audio_lpr)
    taps_audio_lmr = create_fir_lpf(cfg.order_poly_ds_lpf_audio, cfg.k_audio_lmr)

    k_rds = cfg.analog.f_rds_bandwidth / (r.fs_fm_out / 2.0)
    taps_rds = create_fir_lpf(cfg.order_poly_ds_lpf_rds, k_rds)

    k_pilot = cfg.analog.f_pilot / (r.fs_fm_out / 2.0)
    peak_b, peak_a = create_iir_peak_1_filter(k_pilot, 0.9999)

    deemph_b, deemph_a = create_iir_single_pole_lpf(cfg.k_deemphasis)

    k_pll_lpf = cfg.analog.f_pilot_deviation / (r.fs_fm_out / 2.0)
    pll_lpf_b, pll_lpf_a = create_iir_single_pole_lpf(k_pll_lpf)
    pll = make_pilot_pll_params(
        r.fs_fm_out,
        cfg.analog.f_pilot,
        cfg.analog.f_pilot_deviation,
        cfg.pilot_pll_integrator_gain,
        cfg.pilot_pll_proportional_gain,
        pll_lpf_b,
        pll_lpf_a,
    )
    bpsk = make_bpsk_params(cfg.bpsk)

    as_j = lambda x: jnp.asarray(x)
    return DemodCoeffs(
        taps_fm_in=as_j(taps_fm_in),
        taps_fm_out=as_j(taps_fm_out),
        taps_hilbert=as_j(taps_hilbert),
        taps_audio_lpr=as_j(taps_audio_lpr),
        taps_audio_lmr=as_j(taps_audio_lmr),
        taps_rds=as_j(taps_rds),
        peak_b=as_j(peak_b),
        peak_a=as_j(peak_a),
        deemph_b=as_j(deemph_b),
        deemph_a=as_j(deemph_a),
        pll=pll,
        bpsk=bpsk,
    )

@functools.partial(jax.jit, static_argnames=("cfg", "channels"))
def demod_init_state(cfg: DemodConfig, channels: int) -> dict:
    """The complete cross-block carry (SURVEY.md §5.4): FIR tails, IIR
    histories, AGC gains, loop scalars.  Everything [C, ...].

    Jitted so every leaf is created on the device in one launch.
    """
    r = cfg.rates
    c = channels
    nn_in = cfg.order_poly_ds_lpf_fm_out
    nn_out = cfg.order_poly_ds_lpf_fm_out
    nn_aud = cfg.order_poly_ds_lpf_audio
    nn_rds = cfg.order_poly_ds_lpf_rds
    return {
        "ds_fm_in": jnp.zeros((c, nn_in - r.ds_fm_in), jnp.complex64),
        "disc_prev_theta": jnp.zeros((c,), jnp.float32),
        "ds_fm_out": jnp.zeros((c, nn_out - r.ds_fm_out), jnp.float32),
        "deemph": iir_init_state(c, 1),
        "hilbert": jnp.zeros((c, cfg.order_fir_hilbert - 1), jnp.float32),
        "peak_pilot": iir_init_state(2 * c, 2),  # complex as stacked re/im
        "agc_pilot": agc_init_state(c),
        "pll": pilot_pll_init_state(c),
        "ds_audio_lpr": jnp.zeros((c, nn_aud - r.ds_audio), jnp.complex64),
        "ds_audio_lmr": jnp.zeros((c, nn_aud - r.ds_audio), jnp.complex64),
        "lmr_phase_err": jnp.zeros((c,), jnp.float32),
        "ds_rds": jnp.zeros((c, nn_rds - r.ds_rds), jnp.complex64),
        "agc_rds": agc_init_state(c),
        "bpsk": bpsk_init_state(c),
    }


def loop_kernels_enabled(cfg: DemodConfig, include_taps: bool = False) -> bool:
    """Whether demod_block runs the serial loops as the Pallas kernels.

    ``loop_impl="pallas"`` always does (they compile for a GPU only; tests
    call the kernels with ``interpret=True``); ``"scan"`` never;
    ``"auto"`` does on a GPU backend unless the loops' debug taps are asked
    for (only the scan emits them).  ``pll_time_chunks > 1`` is implemented
    by the kernel path alone, so it is refused on the scan path."""
    use = cfg.loop_impl == "pallas" or (
        cfg.loop_impl == "auto"
        and jax.default_backend() == "gpu"
        and not include_taps
    )
    if not use and cfg.pll_time_chunks > 1:
        raise ValueError(
            "pll_time_chunks > 1 runs only on the kernel path "
            f"(loop_impl={cfg.loop_impl!r} chose the scan here)")
    return use


@functools.partial(jax.jit, static_argnames=("cfg", "include_taps"))
def demod_block(
    cfg: DemodConfig,
    coeffs: DemodCoeffs,
    state: dict,
    x: jnp.ndarray,
    include_taps: bool = False,
):
    """Demodulate one baseband block.

    x: [C, B] complex64 (centered IQ, i.e. u8 - 127 per app.cpp:57-63),
    the plane form [2, C, B] f32 (re, im), [2, C, B] int8 planes
    (utils/transfer.split_iq_i8, the capture's own bytes) or [C, B] packed
    f32 words (utils/transfer.pack_iq_u8).
    Returns (state', outs): outs["audio"] [C, B/32, 2] f32,
    outs["rds_pred"]/[C, B/64] soft symbols with outs["rds_valid"] mask.
    With include_taps=True every named intermediate is returned too (the
    GUI tap-point API of broadcast_fm_demod.h:240-268).

    Internally every complex signal travels as a (re, im) tuple of f32
    planes, which avoids one full-array extraction/reconstruction per stage.

    The two serial feedback loops (pilot PLL, BPSK sync) run as the Pallas
    GPU kernels or as ``lax.scan`` per :func:`loop_kernels_enabled`.  The
    stages run under ``jax.named_scope`` names (front_end, mid_end,
    pilot_pll, extract, rds_sync) that profiler traces are reduced by.
    """
    r = cfg.rates
    st = dict(state)
    use_kernels = loop_kernels_enabled(cfg, include_taps)

    if jnp.iscomplexobj(x):
        xp = (x.real, x.imag)
    elif x.ndim == 2:
        # packed u8 IQ words (utils/transfer.pack_iq_u8), unpacked exactly
        assert x.dtype == jnp.float32, (
            f"2-D input must be packed f32 IQ words (pack_iq_u8), got "
            f"{x.dtype}; int8 ingest uses [2, C, B] planes (split_iq_i8)")
        xp = unpack_iq_words(x)
    elif x.dtype == jnp.int8:
        # [2, C, B] int8 (I-128, Q-128) planes (utils/transfer.split_iq_i8):
        # the radio's native bytes, 2 B per complex sample over the host
        # link and in device memory; the exact f32 cast fuses into the
        # front end's first pass
        assert x.ndim == 3 and x.shape[0] == 2
        xp = i8_planes_to_f32(x)
    else:  # [2, C, B] plane form
        assert x.ndim == 3 and x.shape[0] == 2
        xp = (x[0], x[1])

    # ---- 1. FM demodulation ---------------------------------------------
    with jax.named_scope("front_end"):
        st["ds_fm_in"], fm_in_p = polyphase_decimate_p(
            coeffs.taps_fm_in, st["ds_fm_in"], xp, r.ds_fm_in
        )
        st["disc_prev_theta"], fm_demod = fm_discriminate_p(
            st["disc_prev_theta"], fm_in_p,
            cfg.analog.f_wbfm_deviation, float(r.fs_fm_in),
        )

    with jax.named_scope("mid_end"):
        st["ds_fm_out"], fm_out = polyphase_decimate(
            coeffs.taps_fm_out, st["ds_fm_out"], fm_demod, r.ds_fm_out
        )
        if cfg.use_deemphasis_filter:
            st["deemph"], fm_out = iir_filter(
                coeffs.deemph_b, coeffs.deemph_a, st["deemph"], fm_out
            )
        st["hilbert"], fm_out_iq_p = hilbert_fir_p(
            coeffs.taps_hilbert, st["hilbert"], fm_out
        )
        st["peak_pilot"], pilot_p = iir_filter_planes(
            coeffs.peak_b, coeffs.peak_a, st["peak_pilot"], fm_out_iq_p
        )
        if include_taps:
            st["agc_pilot"], pilot_p = agc_process_p(
                st["agc_pilot"], pilot_p, target_power=1.0
            )
        else:
            # The PLL phase detector is amplitude-invariant (atan2(g*im,
            # g*re) == atan2(im, re), g > 0), so off the taps path the AGC
            # gain state is tracked (exact parity for checkpoints) but the
            # scaling pass over the pilot is skipped.
            st["agc_pilot"] = agc_update_gain(st["agc_pilot"], pilot_p, 1.0)

    # ---- 2. Lock onto pilot ---------------------------------------------
    with jax.named_scope("pilot_pll"):
        if use_kernels:
            st["pll"], dt = pilot_pll_pallas(cfg, st["pll"], pilot_p)
            pll_taps = {"dt": dt}
        else:
            st["pll"], pll_taps = pilot_pll_scan(
                coeffs.pll, st["pll"], jax.lax.complex(*pilot_p))
            dt = pll_taps["dt"]

    # ---- 3. Extract components ------------------------------------------
    h_lmr = cfg.analog.f_audio_lmr_center / cfg.analog.f_pilot  # 2.0
    h_rds = cfg.analog.f_rds_center / cfg.analog.f_pilot        # 3.0
    with jax.named_scope("extract"):
        # L+R: Re of the decimated analytic signal (the imag output is dead)
        st["ds_audio_lpr"], audio_lpr = polyphase_decimate_p(
            coeffs.taps_audio_lpr, st["ds_audio_lpr"], fm_out_iq_p, r.ds_audio,
            imag_out=False,
        )
        # L-R: mix with harmonic 2 using the *current* carried phase offset,
        # then update the offset from the mixed+decimated signal
        # (broadcast_fm_demod.cpp:483-521, exact order preserved)
        mixed_lmr_p = apply_harmonic_pll_p(
            dt, fm_out_iq_p, h_lmr, st["lmr_phase_err"]
        )
        st["ds_audio_lmr"], tmp_lmr_p = polyphase_decimate_p(
            coeffs.taps_audio_lmr, st["ds_audio_lmr"], mixed_lmr_p, r.ds_audio
        )
        stride = cfg.audio_lmr_phase_read_stride
        phase = jnp.arctan2(tmp_lmr_p[1][:, ::stride],
                            tmp_lmr_p[0][:, ::stride])
        half_pi = jnp.float32(jnp.pi / 2.0)
        est = jnp.where(phase > 0.0, half_pi - phase, -half_pi - phase)
        new_off = st["lmr_phase_err"] \
            + jnp.float32(cfg.audio_lmr_phase_beta) * jnp.mean(est, axis=-1)
        st["lmr_phase_err"] = jnp.fmod(new_off, jnp.float32(2.0 * jnp.pi))
        audio_lmr = tmp_lmr_p[1]

        # RDS: mix with harmonic 3, zero offset
        mixed_rds_p = apply_harmonic_pll_p(dt, fm_out_iq_p, h_rds, 0.0)
        st["ds_rds"], rds_p = polyphase_decimate_p(
            coeffs.taps_rds, st["ds_rds"], mixed_rds_p, r.ds_rds
        )

    # ---- 4. RDS synchronisation -----------------------------------------
    with jax.named_scope("rds_sync"):
        st["agc_rds"], rds_agc_p = agc_process_p(
            st["agc_rds"], rds_p, target_power=cfg.bpsk.agc_target_power
        )
        if use_kernels:
            st["bpsk"], bpsk_outs = bpsk_sync_pallas(cfg, st["bpsk"], rds_agc_p)
        else:
            st["bpsk"], bpsk_outs = bpsk_sync_scan(
                coeffs.bpsk, st["bpsk"], jax.lax.complex(*rds_agc_p),
                debug_taps=include_taps,
            )

    # ---- 5. Audio mixing (cpp:549-585) ---------------------------------
    if cfg.audio_out == AudioOut.STEREO:
        k = jnp.float32(cfg.audio_stereo_mix_factor)
        left = audio_lpr + k * audio_lmr
        right = audio_lpr - k * audio_lmr
    elif cfg.audio_out == AudioOut.LMR:
        left = right = audio_lmr
    else:
        left = right = audio_lpr
    audio = jnp.stack([left, right], axis=-1) * jnp.float32(2.0)

    outs = {
        "audio": audio,                      # [C, B_audio, 2]
        "rds_sym": bpsk_outs["sym"],         # [C, B_rds] complex
        "rds_pred": bpsk_outs["pred"],       # [C, B_rds] soft symbols
        "rds_valid": bpsk_outs["valid"],     # [C, B_rds] bool
    }
    if include_taps:
        outs["taps"] = {
            "fm_in": jax.lax.complex(*fm_in_p),
            "fm_demod": fm_demod,
            "fm_out": fm_out,
            "fm_out_iq": jax.lax.complex(*fm_out_iq_p),
            "pilot": jax.lax.complex(*pilot_p),
            "pll_dt": dt,
            # loop-internal taps exist only on the scan path
            "pll": pll_taps.get("pll"),
            "pll_raw_phase_error": pll_taps.get("raw_pe"),
            "pll_lpf_phase_error": pll_taps.get("pi_pe"),
            "audio_lpr": audio_lpr,
            "audio_lmr": audio_lmr,
            "audio_lmr_iq": jax.lax.complex(*tmp_lmr_p),
            "rds": jax.lax.complex(*rds_p),
            "rds_agc": jax.lax.complex(*rds_agc_p),
            "bpsk_iq": bpsk_outs.get("iq"),
        }
        # the six remaining BPSK debug buffers (bpsk_synchroniser.h:63-70),
        # present on the scan path
        for k in ("zcd_trig", "ted_raw_phase_error", "ted_pi_phase_error",
                  "pll_raw_phase_error", "pll_pi_phase_error",
                  "int_dump_filter"):
            outs["taps"][f"bpsk_{k}"] = bpsk_outs.get(k)
    return st, outs


from fm_radio.utils.lru import LRUCache

_COEFF_CACHE = LRUCache(16)


class BroadcastFMDemod:
    """Convenience stateful wrapper around the pure functions (host driver).

    Mirrors the reference's ``Broadcast_FM_Demod`` public surface: sample-rate
    getters (``broadcast_fm_demod.h:283-288``) and per-block processing with
    tap-point access.
    """

    def __init__(self, cfg: DemodConfig = DemodConfig(), channels: int = 1):
        self.cfg = cfg
        self.channels = channels
        self.coeffs = make_coeffs(cfg)
        self.state = demod_init_state(cfg, channels)
        self.last_taps: dict | None = None

    # sample-rate getters
    @property
    def fs_baseband(self):
        return self.cfg.rates.fs_baseband

    @property
    def fs_fm_in(self):
        return self.cfg.rates.fs_fm_in

    @property
    def fs_fm_out(self):
        return self.cfg.rates.fs_fm_out

    @property
    def fs_rds(self):
        return self.cfg.rates.fs_rds

    @property
    def fs_audio(self):
        return self.cfg.rates.fs_audio

    def update_controls(self, **changes) -> None:
        """Runtime-mutable controls, mirroring the reference's GUI dirty-flag
        redesign (``EditableControl`` + ``UpdateFilters``,
        ``broadcast_fm_demod.cpp:330-389``): change cutoffs / audio mode /
        de-emphasis mid-stream; coefficients are re-designed on host and the
        carried state is preserved (filter ORDERS are compile-time constants
        in the reference too, so state shapes never change).

        e.g. ``d.update_controls(audio_out="lpr", use_deemphasis_filter=True,
        deemphasis_cutoff_us=50, audio_lpr_cutoff_hz=12000)``
        """
        import dataclasses

        allowed = {
            "audio_out",
            "audio_stereo_mix_factor",
            "use_deemphasis_filter",
            "deemphasis_cutoff_us",
            "audio_lpr_cutoff_hz",
            "audio_lmr_cutoff_hz",
        }
        bad = set(changes) - allowed
        if bad:
            raise ValueError(f"not runtime-mutable: {sorted(bad)}")
        self.cfg = dataclasses.replace(self.cfg, **changes)
        # LRU-memoized redesign (lru_cache.h parity): toggling between a few
        # control settings re-runs the full designer pass only once per
        # distinct config; state shapes are unchanged by any allowed control.
        self.coeffs = _COEFF_CACHE.get_or_create(
            self.cfg, lambda: make_coeffs(self.cfg)
        )

    def process(self, x: np.ndarray, include_taps: bool = False) -> dict:
        """x: [C, B] complex64 centered baseband, [C, B] f32 of packed
        u8 IQ words (utils/transfer.pack_iq_u8), or [2, C, B] int8 planes
        (utils/transfer.split_iq_i8). Returns outs dict (numpy)."""
        from fm_radio.utils.transfer import device_put_complex, fetch_tree

        if x.ndim == 1:
            x = x[None, :]
        if np.iscomplexobj(x) and isinstance(x, np.ndarray):
            xd = device_put_complex(x)  # host complex crosses the wire as f32
        elif isinstance(x, np.ndarray):
            xd = jnp.asarray(
                x if x.dtype == np.int8 else np.asarray(x, np.float32))
        else:
            # already a device array (e.g. channelizer output fed straight to
            # the demod): use in place, complex or not — no host round trip
            xd = jnp.asarray(x)
        self.state, outs = demod_block(
            self.cfg, self.coeffs, self.state, xd, include_taps
        )
        outs = fetch_tree(outs)
        if include_taps:
            self.last_taps = outs.get("taps")
        return outs

    def reset(self):
        self.state = demod_init_state(self.cfg, self.channels)
