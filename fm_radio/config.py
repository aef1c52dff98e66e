"""Configuration dataclasses for the broadcast-FM demodulator.

One explicit config tree replaces the reference's three scattered tiers
(CLI getopt flags, compile-time struct defaults at
``src/fm_demod/broadcast_fm_demod.h:27-61``, and runtime GUI dirty-flag
controls at ``broadcast_fm_demod.h:64-89``).  Everything static under ``jit``
lives here; changing a cutoff re-designs coefficients on host and re-traces.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class AnalogParams:
    """Fixed parameters of the analogue broadcast-FM transmission.

    Parity: ``Broadcast_FM_Demod_Analog_Parameters``
    (``src/fm_demod/broadcast_fm_demod.h:27-40``).
    """

    f_wbfm_deviation: float = 75e3    # WBFM deviation (Hz)
    f_audio_lpr: int = 15_000         # L+R mono band edge (Hz)
    f_pilot: int = 19_000             # pilot tone = 1st harmonic (Hz)
    f_pilot_deviation: int = 100      # pilot PLL pull range (Hz)
    f_audio_lmr_center: int = 38_000  # L-R DSB-SC center = 2nd harmonic (Hz)
    f_audio_lmr_bandwidth: int = 15_000
    f_rds_center: int = 57_000        # RDS BPSK center = 3rd harmonic (Hz)
    f_rds_bandwidth: int = 2_000
    tus_min_deemphasis: int = 1       # de-emphasis time constant bounds (µs)
    tus_max_deemphasis: int = 100


@dataclasses.dataclass(frozen=True)
class RateConfig:
    """Sample-rate cascade.

    Parity: hardcoded cascade at ``src/fm_demod/broadcast_fm_demod.cpp:62-77``
    (the reference leaves a ``TODO: make user configurable`` — here it is).
    """

    fs_baseband: int = 1_024_000
    ds_fm_in: int = 4      # baseband -> fm_in     (256 kHz)
    ds_fm_out: int = 2     # fm_in    -> fm_out    (128 kHz)
    ds_rds: int = 8        # fm_out   -> rds       (16 kHz)
    ds_audio: int = 4      # fm_out   -> audio     (32 kHz)

    @property
    def fs_fm_in(self) -> int:
        return self.fs_baseband // self.ds_fm_in

    @property
    def fs_fm_out(self) -> int:
        return self.fs_fm_in // self.ds_fm_out

    @property
    def fs_rds(self) -> int:
        return self.fs_fm_out // self.ds_rds

    @property
    def fs_audio(self) -> int:
        return self.fs_fm_out // self.ds_audio

    def block_sizes(self, block_size: int) -> dict:
        """Per-stage block lengths for a baseband block of ``block_size``."""
        b_fm_in = block_size // self.ds_fm_in
        b_fm_out = b_fm_in // self.ds_fm_out
        return {
            "baseband": block_size,
            "fm_in": b_fm_in,
            "fm_out": b_fm_out,
            "rds": b_fm_out // self.ds_rds,
            "audio": b_fm_out // self.ds_audio,
        }


@dataclasses.dataclass(frozen=True)
class BPSKConfig:
    """BPSK symbol synchroniser loop constants.

    Parity: ``BPSK_Synchroniser_Config`` (``src/fm_demod/bpsk_synchroniser.h:18-32``).
    """

    f_sample_rate: float = 16e3
    f_symbol_rate: float = 2e3
    ted_integrator_gain: float = 10.0
    ted_proportional_gain: float = 0.3
    pll_integrator_gain: float = 10.0
    pll_proportional_gain: float = 0.3
    ted_max_freq_offset: float = 1.5e3
    pll_max_freq_offset: float = 10.0
    agc_target_power: float = 0.5

    @property
    def samples_per_symbol(self) -> int:
        return int(round(self.f_sample_rate / self.f_symbol_rate))

    @property
    def zcd_cooldown(self) -> int:
        return self.samples_per_symbol // 2


class AudioOut:
    """Audio mixer mode (``broadcast_fm_demod.h:80``)."""

    LPR = "lpr"
    LMR = "lmr"
    STEREO = "stereo"


@dataclasses.dataclass(frozen=True)
class DemodConfig:
    """Full demodulator configuration: analog constants + filter orders +
    loop gains + runtime-controllable options, in one place.

    Parity: ``Broadcast_FM_Demod_Config`` (``broadcast_fm_demod.h:43-61``)
    and ``Broadcast_FM_Demod_Controls`` (``broadcast_fm_demod.h:64-89``).
    """

    analog: AnalogParams = dataclasses.field(default_factory=AnalogParams)
    rates: RateConfig = dataclasses.field(default_factory=RateConfig)
    bpsk: BPSKConfig = dataclasses.field(default_factory=BPSKConfig)

    # Filter orders (broadcast_fm_demod.h:43-61).  NOTE: the reference sizes
    # the fm_in decimator with order_poly_ds_lpf_fm_out (broadcast_fm_demod.cpp:134)
    # — replicated: both use `order_poly_ds_lpf_fm_out`.
    order_poly_ds_lpf_fm_in: int = 64
    order_poly_ds_lpf_fm_out: int = 64
    order_fir_hilbert: int = 65       # must be odd for antisymmetry
    order_poly_ds_lpf_rds: int = 128
    order_poly_ds_lpf_audio: int = 128

    # Pilot PLL PI gains (broadcast_fm_demod.h:49-52)
    pilot_pll_integrator_gain: float = 0.1
    pilot_pll_proportional_gain: float = 0.01

    # L-R phase correction (broadcast_fm_demod.h:57-60)
    audio_lmr_phase_beta: float = 0.1
    audio_lmr_phase_read_stride: int = 10

    # Early roll-off on decimating LPFs (broadcast_fm_demod.cpp:129)
    downsampling_rolloff_factor: float = 0.95

    # Feedback-loop implementation (models/demod.py::loop_kernels_enabled):
    # "scan" (lax.scan, reference-exact debug taps), "pallas" (the Triton
    # GPU kernels, kernels/), or "auto" (the kernels on a GPU backend when
    # the loops' debug taps aren't requested; scan otherwise).
    loop_impl: str = "auto"

    # Block-parallel pilot PLL (SURVEY.md §7): split each block's serial loop
    # into G time chunks riding the kernel's channel axis, warm-up re-locked
    # and NCO-phase-seeded from the signal.  1 (default) = exact sequential
    # reference order.  G>1 trades ~3e-3-cycle rms dt deviation (RDS
    # decisions unchanged, audio ~-35 dB vs sequential) for ~G-fold fewer
    # serial steps — worthwhile at LOW channel counts, e.g. single-station
    # latency.  Kernel path only: the scan path refuses G>1, and a block
    # whose PLL length N is not divisible by G, or whose N/G does not exceed
    # pll_chunk_warmup, is refused.
    pll_time_chunks: int = 1
    pll_chunk_warmup: int = 4096

    # Runtime-controllable (GUI controls in the reference; jit-static here).
    audio_out: str = AudioOut.STEREO
    audio_stereo_mix_factor: float = 1.0
    use_deemphasis_filter: bool = False
    deemphasis_cutoff_us: int = 1     # Tus; fc = 1/(2*pi*T)
    audio_lpr_cutoff_hz: int = 15_000
    audio_lmr_cutoff_hz: int = 15_000

    def __post_init__(self):
        if self.order_fir_hilbert % 2 != 1:
            raise ValueError("order_fir_hilbert must be odd")
        if self.loop_impl not in ("auto", "scan", "pallas"):
            raise ValueError(
                f"loop_impl must be auto, scan or pallas: {self.loop_impl!r}")
        if self.pll_time_chunks < 1:
            raise ValueError("pll_time_chunks must be >= 1")

    # ---- derived normalized cutoffs (k = Fc / (Fs/2), clamped to (0.01, 0.99)
    #      like UpdateFilters at broadcast_fm_demod.cpp:330-389) -------------

    @staticmethod
    def _clamp_k(k: float) -> float:
        return min(max(k, 0.01), 0.99)

    @property
    def k_deemphasis(self) -> float:
        tc = float(self.deemphasis_cutoff_us) * 1e-6
        fc = 1.0 / (2.0 * math.pi * tc)
        return self._clamp_k(fc / (self.rates.fs_fm_out / 2.0))

    @property
    def k_audio_lpr(self) -> float:
        return self._clamp_k(self.audio_lpr_cutoff_hz / (self.rates.fs_fm_out / 2.0))

    @property
    def k_audio_lmr(self) -> float:
        return self._clamp_k(self.audio_lmr_cutoff_hz / (self.rates.fs_fm_out / 2.0))
