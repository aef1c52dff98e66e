"""Live terminal dashboard — the framework's equivalent of the reference GUI.

Parity: the reference renders every internal tap point with ImGui/ImPlot
(``src/gui/``, SURVEY.md §2.8): seven magnitude spectra with per-plot
display-mode controls (``render_fm_demod.cpp:94-303,375-443``), time-domain
and constellation plots (``render_fm_demod.cpp:499-640``), BPSK-sync loop
internals (``render_bpsk_sync.cpp:10-75``), the RDS database table
(``render_rds_database.cpp:9-47``) and a profiler viewer
(``render_profiler.cpp:9-67``).  An accelerator host is headless, so this module
renders the same panels as a self-refreshing ANSI terminal dashboard driven
by the tap-point API (``demod_block(include_taps=True)``) — same signals,
same display modes (NORMAL/AVERAGE/MAX_HOLD via ``ops/spectrum.SpectrumView``),
plus live throughput the reference GUI never shows.

The frame renderer is a pure function of a stats snapshot, so tests assert on
its output without a tty.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np

# ----------------------------------------------------------------------------
# low-level character plotting

_BLOCKS = " ▁▂▃▄▅▆▇█"  # ▁▂▃▄▅▆▇█
_ASCII = " .:-=+*#%@"


def spark(values: np.ndarray, width: int = 64, vmin: float | None = None,
          vmax: float | None = None, ascii_only: bool = False) -> str:
    """One-row sparkline of ``values`` resampled to ``width`` columns."""
    ramp = _ASCII if ascii_only else _BLOCKS
    v = np.asarray(values, np.float64)
    v = v[np.isfinite(v)] if not np.all(np.isfinite(v)) else v
    if v.size == 0:
        return " " * width
    # bucket-average down to width columns
    idx = np.linspace(0, v.size, width + 1).astype(int)
    cols = np.array([v[a:b].mean() if b > a else v[min(a, v.size - 1)]
                     for a, b in zip(idx[:-1], idx[1:])])
    lo = float(np.min(cols)) if vmin is None else vmin
    hi = float(np.max(cols)) if vmax is None else vmax
    span = max(hi - lo, 1e-9)
    q = np.clip((cols - lo) / span * (len(ramp) - 1), 0, len(ramp) - 1)
    return "".join(ramp[int(round(x))] for x in q)


def scatter(re: np.ndarray, im: np.ndarray, width: int = 37, height: int = 9,
            lim: float | None = None) -> list[str]:
    """Character-grid constellation plot (``render_util.h`` ComplexScatter)."""
    re = np.asarray(re, np.float64).ravel()
    im = np.asarray(im, np.float64).ravel()
    grid = [[" "] * width for _ in range(height)]
    cx, cy = width // 2, height // 2
    for y in range(height):
        grid[y][cx] = "│"  # │ axis
    for x in range(width):
        grid[cy][x] = "─"  # ─
    grid[cy][cx] = "┼"  # ┼
    if re.size:
        if lim is None:
            lim = max(1e-9, 1.2 * float(np.percentile(np.hypot(re, im), 95)))
        xs = np.clip(((re / lim) * 0.5 + 0.5) * (width - 1), 0, width - 1)
        ys = np.clip((0.5 - (im / lim) * 0.5) * (height - 1), 0, height - 1)
        for x, y in zip(xs.astype(int), ys.astype(int)):
            grid[y][x] = "●"  # ●
    return ["".join(row) for row in grid]


def _meter(value: float, lo: float, hi: float, width: int = 20) -> str:
    frac = 0.0 if hi <= lo else min(max((value - lo) / (hi - lo), 0.0), 1.0)
    n = int(round(frac * width))
    return "[" + "#" * n + "-" * (width - n) + "]"


# ----------------------------------------------------------------------------
# frame snapshot + renderer


@dataclasses.dataclass
class FrameStats:
    """Everything one dashboard frame displays (host-side numpy only)."""

    block_index: int = 0
    total_samples: int = 0
    samples_per_s: float = 0.0
    spectra: dict = dataclasses.field(default_factory=dict)  # name -> dB array
    spectrum_mode: str = "average"
    # pilot loop
    pll_phase_error_rms: float = 0.0
    pll_locked: bool = False
    # audio
    audio_rms: tuple = (0.0, 0.0)
    stereo_lmr_rms: float = 0.0
    # BPSK sync internals (render_bpsk_sync.cpp:10-75)
    bpsk_points: tuple = (np.zeros(0), np.zeros(0))
    bpsk_ted_error_rms: float = 0.0
    bpsk_pll_error_rms: float = 0.0
    symbols_seen: int = 0
    # RDS database (render_rds_database.cpp:9-47)
    rds: dict = dataclasses.field(default_factory=dict)
    groups_seen: int = 0
    last_group_line: str = ""
    # profiler (render_profiler.cpp:9-67)
    stage_ms: dict = dataclasses.field(default_factory=dict)
    # time-domain scope page (render_fm_demod.cpp:499-640): name -> waveform
    scope: dict = dataclasses.field(default_factory=dict)


# display band labels: tap name -> (title, band note) — the reference GUI's
# seven magnitude spectra (render_fm_demod.cpp:98-273: Baseband, FM Input,
# FM Output, Pilot Tone, Audio L+R, Audio L-R, RDS).  "baseband" is the raw
# input block (not a demod tap); the rest come from the tap-point API.
SPECTRUM_TAPS = {
    "baseband": ("baseband (1.024 MHz)", "raw IQ"),
    "fm_in": ("FM input (256 kHz)", "post ↓4"),
    "fm_out": ("FM output (128 kHz)", "mono+pilot+L-R+RDS"),
    "pilot": ("pilot tone (128 kHz)", "19 kHz"),
    "audio_lpr": ("audio L+R (32 kHz)", ""),
    "audio_lmr": ("audio L-R (32 kHz)", ""),
    "rds": ("RDS band (16 kHz)", "57 kHz →0"),
}

SPECTRUM_MODES = ("normal", "average", "max_hold")

# time-domain scope page: the reference GUI's waveform plots
# (render_fm_demod.cpp:499-640: IQ Signal, Audio Output, Audio L+R,
# Audio L-R, Pilot, PLL, PLL Phase Error; RDS Pred Symbols is the
# constellation panel, always shown)
SCOPE_PANELS = (
    ("iq", "IQ signal (Re, 128 kHz)"),
    ("audio_l", "audio out L (32 kHz)"),
    ("audio_r", "audio out R (32 kHz)"),
    ("audio_lpr", "audio L+R (32 kHz)"),
    ("audio_lmr", "audio L-R (32 kHz)"),
    ("pilot", "pilot (Re, 128 kHz)"),
    ("pll", "PLL NCO (Re, 128 kHz)"),
    ("pll_err", "PLL phase error (raw, 128 kHz)"),
)


def render_frame(s: FrameStats, width: int = 64, ascii_only: bool = False,
                 channels: int = 1) -> str:
    """Pure renderer: stats snapshot -> dashboard text."""
    bar = "─" * (width + 14) if not ascii_only else "-" * (width + 14)
    out: list[str] = []
    rt = s.samples_per_s / 1.024e6 if s.samples_per_s else 0.0
    out.append(
        f"fmtpu monitor   block {s.block_index}   "
        f"{s.total_samples/1e6:.1f} MS in   "
        f"{s.samples_per_s/1e6:.2f} MS/s ({rt:.1f}x real-time"
        + (f", {channels} ch" if channels > 1 else "") + ")"
    )
    out.append(bar)

    # spectra panels (or the time-domain scope page when toggled)
    if s.scope:
        for key, title in SCOPE_PANELS:
            w = s.scope.get(key)
            if w is None:
                continue
            w = np.asarray(w, np.float64)
            amp = max(float(np.max(np.abs(w))) if w.size else 0.0, 1e-9)
            line = spark(w, width=width, vmin=-amp, vmax=amp,
                         ascii_only=ascii_only)
            out.append(f"{title:<28} |{line}| ±{amp:.3g}")
    else:
        for name, (title, note) in SPECTRUM_TAPS.items():
            db = s.spectra.get(name)
            if db is None:
                continue
            line = spark(db, width=width, ascii_only=ascii_only)
            lo, hi = float(np.min(db)), float(np.max(db))
            out.append(f"{title:<22} |{line}| {lo:5.0f}..{hi:4.0f} dB"
                       + (f"  {note}" if note else ""))
    out.append(bar)

    # pilot + audio row
    lock = "LOCKED" if s.pll_locked else "UNLOCKED"
    out.append(
        f"pilot PLL: {lock}  phase-err RMS {s.pll_phase_error_rms:7.4f} rad  "
        f"{_meter(-s.pll_phase_error_rms, -0.5, 0.0)}"
    )
    l_rms, r_rms = s.audio_rms
    out.append(
        f"audio: L {_meter(l_rms, 0, 1.0)} {l_rms:5.3f}   "
        f"R {_meter(r_rms, 0, 1.0)} {r_rms:5.3f}   L-R {s.stereo_lmr_rms:5.3f}"
    )
    out.append(bar)

    # BPSK constellation + loop internals side by side
    con = scatter(*s.bpsk_points, lim=1.5)
    info = [
        "BPSK symbol sync",
        f"  symbols      {s.symbols_seen}",
        f"  TED err RMS  {s.bpsk_ted_error_rms:6.3f}",
        f"  PLL err RMS  {s.bpsk_pll_error_rms:6.3f}",
        "",
        "RDS",
        f"  groups       {s.groups_seen}",
        f"  PI           {s.rds.get('pi', 0):04X}",
        f"  PTY          {s.rds.get('pty_name', '')}",
        f"  AF           {s.rds.get('af', '')}",
    ]
    for i in range(max(len(con), len(info))):
        left = con[i] if i < len(con) else " " * len(con[0])
        right = info[i] if i < len(info) else ""
        out.append(f"  {left}   {right}")
    out.append(bar)

    # RDS database table
    out.append(
        f"station: '{s.rds.get('ps', '')}'   "
        f"radiotext: '{s.rds.get('rt', '')}'"
    )
    ct = s.rds.get("ct", "")
    flags = s.rds.get("flags", "")
    out.append(f"clock: {ct}   {flags}")
    if s.last_group_line:
        out.append(f"last group: {s.last_group_line[:width + 12]}")
    out.append(bar)

    # profiler
    if s.stage_ms:
        parts = [f"{k} {v:6.2f} ms" for k, v in s.stage_ms.items()]
        out.append("stages/frame: " + "  ".join(parts))
    return "\n".join(out)


# ----------------------------------------------------------------------------
# interactive runtime controls


class ControlSurface:
    """Key bindings driving ``BroadcastFMDemod.update_controls`` — live-
    control parity with the reference GUI's demod panel
    (``render_fm_demod.cpp:305-374``: audio-mode combo, L-R gain slider
    0..5, L+R / L-R cutoff sliders 0..15k, de-emphasis checkbox + 1..100 µs
    slider).  Each handled key mutates the LIVE pipeline mid-stream via the
    dirty-flag coefficient redesign; returns a status string (or None for
    unbound keys)."""

    MODES = ("stereo", "lpr", "lmr")
    HELP = ("keys: m=mode g/G=L-R gain l/L=L+R cutoff r/R=L-R cutoff "
            "e=deemph [/]=deemph-us v=spectrum-mode p=scope-page "
            "n/N=retune q=quit")

    def __init__(self, demod):
        self.demod = demod

    def _set(self, **changes) -> None:
        self.demod.update_controls(**changes)

    def handle_key(self, ch: str) -> str | None:
        # exactly one printable character: '' (undecodable byte) would match
        # `ch in "gG"` (any '' is "in" every string) and escape-sequence
        # fragments must not hit bindings
        if not ch or len(ch) != 1 or not ch.isprintable():
            return None
        cfg = self.demod.cfg
        if ch == "m":
            mode = self.MODES[(self.MODES.index(cfg.audio_out) + 1)
                              % len(self.MODES)]
            self._set(audio_out=mode)
            return f"audio mode -> {mode}"
        if ch in "gG":
            g = min(max(cfg.audio_stereo_mix_factor
                        + (0.25 if ch == "G" else -0.25), 0.0), 5.0)
            self._set(audio_stereo_mix_factor=g)
            return f"L-R gain -> {g:.2f}"
        if ch in "lL":
            hz = min(max(cfg.audio_lpr_cutoff_hz
                         + (1000 if ch == "L" else -1000), 1000), 15000)
            self._set(audio_lpr_cutoff_hz=hz)
            return f"L+R cutoff -> {hz} Hz"
        if ch in "rR":
            hz = min(max(cfg.audio_lmr_cutoff_hz
                         + (1000 if ch == "R" else -1000), 1000), 15000)
            self._set(audio_lmr_cutoff_hz=hz)
            return f"L-R cutoff -> {hz} Hz"
        if ch == "e":
            on = not cfg.use_deemphasis_filter
            self._set(use_deemphasis_filter=on)
            return f"de-emphasis -> {'on' if on else 'off'}"
        if ch in "[]":
            us = min(max(cfg.deemphasis_cutoff_us + (5 if ch == "]" else -5),
                         cfg.analog.tus_min_deemphasis),
                     cfg.analog.tus_max_deemphasis)
            self._set(deemphasis_cutoff_us=us)
            return f"de-emphasis -> {us} us"
        return None

    def status_line(self) -> str:
        cfg = self.demod.cfg
        de = (f"on {cfg.deemphasis_cutoff_us}us"
              if cfg.use_deemphasis_filter else "off")
        return (f"controls: mode={cfg.audio_out} "
                f"L-R gain={cfg.audio_stereo_mix_factor:.2f} "
                f"L+R cutoff={cfg.audio_lpr_cutoff_hz} "
                f"L-R cutoff={cfg.audio_lmr_cutoff_hz} deemph={de}")


class _KeyReader:
    """Non-blocking single-key reader from the controlling terminal.

    Reads from /dev/tty (NOT stdin — the sample stream may own stdin), in
    cbreak mode, restoring terminal state on close.  Silently inert when no
    tty exists (tests, pipes, CI)."""

    def __init__(self):
        self._fd = None
        self._saved = None
        self._tty = None
        try:
            import termios
            import tty
        except ImportError:
            return
        try:
            self._tty = open("/dev/tty", "rb", buffering=0)
            self._fd = self._tty.fileno()
            self._saved = termios.tcgetattr(self._fd)
            tty.setcbreak(self._fd)
        except (OSError, ValueError, termios.error):
            # termios.error derives from Exception directly (NOT OSError):
            # /dev/tty can open but not be a usable terminal
            if self._tty is not None:
                self._tty.close()
                self._tty = None
            self._fd = None
            self._saved = None

    def poll(self) -> str | None:
        if self._fd is None:
            return None
        import select

        def readable() -> bool:
            return bool(select.select([self._fd], [], [], 0)[0])

        if not readable():
            return None
        ch = self._tty.read(1)
        if ch == b"\x1b":
            # escape sequence (arrow/function keys): drain the pending bytes
            # so the '[' CSI byte never reaches a key binding
            while readable():
                if not self._tty.read(1):
                    break
            return None
        return ch.decode(errors="ignore") if ch else None

    def close(self) -> None:
        if self._fd is not None and self._saved is not None:
            import termios

            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._saved)
            self._tty.close()
            self._fd = None


# ----------------------------------------------------------------------------
# live driver


class Monitor:
    """Streams blocks through an :class:`~fm_radio.models.app.App`,
    maintaining SpectrumViews per displayed tap and producing frames.

    Per-block work is kept cheap (production kernel path, no tap fetch);
    taps are requested only for the block a frame is rendered from — the
    reference GUI's pull semantics (``calculate_fft_mag.h:25-28``: spectra
    compute when the display asks, not per DSP block)."""

    def __init__(self, app, mode: str = "average", block_size: int = 65536,
                 on_audio=None):
        from fm_radio.ops.spectrum import SpectrumView

        self.app = app
        self.block_size = block_size
        self.mode = mode
        self.page = "spectra"  # or "scope" (time-domain waveforms)
        # live playback hook: called with ([N,2] float32, fs_audio) per block
        # (the OnAudioBlock -> pcm_player wiring, fm_demod_no_tuner.cpp:171-174)
        self.on_audio = on_audio
        self.views = {name: SpectrumView(mode=mode) for name in SPECTRUM_TAPS}
        self.blocks = 0
        self.samples = 0
        self.symbols = 0
        self.groups_seen = 0
        self.last_group_line = ""
        self._t_last = time.perf_counter()
        self._rate = 0.0
        self._last: tuple[dict, dict, float, float] | None = None

    def step(self, blk: np.ndarray, with_taps: bool = True) -> None:
        """Process one [C, block] (or [block]) chunk.  ``with_taps`` keeps
        the intermediates of THIS block for the next :meth:`snapshot`; pass
        False for blocks between repaints (faster: fused-kernel path, no
        device->host tap fetch)."""
        if blk.ndim == 1:
            blk = blk[None, :]
        t0 = time.perf_counter()
        outs = self.app.demod.process(blk, include_taps=with_taps)
        t1 = time.perf_counter()

        if self.on_audio is not None:
            self.on_audio(np.asarray(outs["audio"][0]),
                          int(self.app.demod.fs_audio))

        # feed RDS chains exactly like App._run_block
        if self.app.decode_rds:
            pred, valid = outs["rds_pred"], outs["rds_valid"]
            for c in range(self.app.channels):
                sym = pred[c][valid[c]]
                if sym.size:
                    self.app.rds_chains[c].process_symbols(sym)
            # drain chain history into bounded monitor state — a live
            # monitor runs for hours and must not accumulate per-group
            # lists (the GUI equivalent keeps ring buffers)
            for c, full_chain in enumerate(self.app.rds_chains):
                ch = full_chain.chain
                if c == 0:
                    self.groups_seen += len(ch.groups)
                    if ch.log_lines:
                        self.last_group_line = ch.log_lines[-1]
                ch.groups.clear()
                ch.log_lines.clear()
                rds_bytes = getattr(full_chain, "rds_bytes", None)
                if rds_bytes:
                    rds_bytes.clear()
        t2 = time.perf_counter()

        self.blocks += 1
        self.samples += blk.shape[-1]
        self.symbols += int(np.asarray(outs["rds_valid"]).sum())
        dt = max(t2 - self._t_last, 1e-9)
        self._t_last = t2
        inst = blk.size / dt
        self._rate = inst if self._rate == 0 else 0.7 * self._rate + 0.3 * inst
        if with_taps:
            taps = dict(outs["taps"])
            taps["baseband"] = blk  # the GUI's Baseband Spectrum input
            self._last = (outs, taps, (t1 - t0) * 1e3, (t2 - t1) * 1e3)

    def toggle_page(self) -> str:
        """Switch between the spectra page and the time-domain scope page
        (the GUI's "Other Signals"/"Audio Signals" windows,
        render_fm_demod.cpp:499-640)."""
        self.page = "scope" if self.page == "spectra" else "spectra"
        return self.page

    def cycle_spectrum_mode(self) -> str:
        """Live display-mode cycle (the GUI's per-plot mode combos,
        render_fm_demod.cpp:375-443, applied to all panels): NORMAL ->
        AVERAGE -> MAX_HOLD.  Fresh views so the new mode starts clean."""
        from fm_radio.ops.spectrum import SpectrumView

        self.mode = SPECTRUM_MODES[
            (SPECTRUM_MODES.index(self.mode) + 1) % len(SPECTRUM_MODES)]
        self.views = {name: SpectrumView(mode=self.mode)
                      for name in SPECTRUM_TAPS}
        return self.mode

    def snapshot(self) -> FrameStats:
        """Build a frame from the most recent tapped block."""
        assert self._last is not None, "step(with_taps=True) first"
        outs, taps, demod_ms, rds_ms = self._last

        stats = FrameStats(
            block_index=self.blocks,
            total_samples=self.samples,
            samples_per_s=self._rate,
            spectrum_mode=self.mode,
        )
        c0 = 0  # display channel 0 (the GUI is single-channel too)
        for name, view in self.views.items():
            arr = taps.get(name)
            if arr is None:
                continue
            view.update(np.asarray(arr[c0]))
            stats.spectra[name] = np.asarray(view.buffer)

        if self.page == "scope":
            audio_blk = np.asarray(outs["audio"][c0])
            scope_src = {
                "iq": np.asarray(taps["fm_out_iq"][c0]).real,
                "audio_l": audio_blk[:, 0] if audio_blk.size else audio_blk,
                "audio_r": audio_blk[:, 1] if audio_blk.size else audio_blk,
                "audio_lpr": np.asarray(taps["audio_lpr"][c0]),
                "audio_lmr": np.asarray(taps["audio_lmr"][c0]),
                "pilot": np.asarray(taps["pilot"][c0]).real,
                "pll": np.asarray(taps["pll"][c0]).real,
                "pll_err": np.asarray(taps["pll_raw_phase_error"][c0]),
            }
            stats.scope = {k: v for k, v in scope_src.items() if v is not None}

        pe = taps.get("pll_lpf_phase_error")
        if pe is not None:
            rms = float(np.sqrt(np.mean(np.square(np.asarray(pe[c0])))))
            stats.pll_phase_error_rms = rms
            stats.pll_locked = rms < 0.2
        audio = np.asarray(outs["audio"][c0])
        if audio.size:
            stats.audio_rms = (
                float(np.sqrt(np.mean(np.square(audio[:, 0])))),
                float(np.sqrt(np.mean(np.square(audio[:, 1])))),
            )
        lmr = taps.get("audio_lmr")
        if lmr is not None:
            stats.stereo_lmr_rms = float(
                np.sqrt(np.mean(np.square(np.asarray(lmr[c0]))))
            )

        iq = taps.get("bpsk_iq")
        valid = np.asarray(outs["rds_valid"][c0])
        if iq is not None:
            pts = np.asarray(iq[c0])[valid]
            stats.bpsk_points = (pts.real, pts.imag)
        stats.symbols_seen = self.symbols
        for key, attr in (("bpsk_ted_pi_phase_error", "bpsk_ted_error_rms"),
                          ("bpsk_pll_pi_phase_error", "bpsk_pll_error_rms")):
            arr = taps.get(key)
            if arr is not None:
                setattr(stats, attr, float(
                    np.sqrt(np.mean(np.square(np.asarray(arr[c0]))))))

        if self.app.decode_rds:
            db = self.app.rds_chains[c0].db
            from fm_radio.rds.database import PROGRAMME_TYPES

            stats.groups_seen = self.groups_seen
            stats.last_group_line = self.last_group_line
            stats.rds = {
                "pi": db.pi_code,
                "ps": db.service_name_str,
                "rt": db.radio_text_str,
                "pty_name": PROGRAMME_TYPES[db.programme_type][1],
                "af": " ".join(f"{f/1e6:.1f}" for f in db.alt_freqs[:4]),
                "ct": (f"{db.hour:02d}:{db.minute:02d} "
                       f"{db.day:02d}/{db.month:02d}/{db.year:04d}"
                       if db.year else ""),
                "flags": (f"stereo={int(db.is_stereo)} "
                          f"music={int(db.is_music)} "
                          f"TA={db.traffic_announcement.name}"),
            }
        stats.stage_ms = {"demod": demod_ms, "rds": rds_ms}
        return stats


class _FileSource:
    """Single-station pcm: yields [k*block] complex baseband per read."""

    def __init__(self, fh, block: int):
        self._fh = fh
        self.block = block
        self.channels = 1
        self.channel = 0

    def read(self, nblocks: int) -> np.ndarray:
        from fm_radio.io.pcm import u8_to_c64

        raw = self._fh.read(2 * self.block * nblocks)
        n = (len(raw) // 2) * 2
        if n == 0:
            return np.zeros(0, np.complex64)
        x = u8_to_c64(np.frombuffer(raw[:n], np.uint8).reshape(-1, 2))
        return x[: (x.size // self.block) * self.block]

    def set_channel(self, k: int) -> None:
        pass


class _WidebandSource:
    """Wideband pcm -> polyphase FFT filterbank -> ONE selected station at
    1.024 MHz.  The filterbank state spans ALL channels, so switching the
    monitored station ('n'/'N') delivers valid signal immediately — the
    monitor equivalent of the reference's device-retune workflow
    (``fm_demod_tuner.cpp:174-176`` + DeviceSelector)."""

    def __init__(self, fh, block: int, m: int, taps_per_phase: int = 16,
                 channel: int = 0):
        from fm_radio.parallel.channelizer import (
            channelizer_init_state,
            make_channelizer_taps,
        )

        self._fh = fh
        self.block = block
        self.channels = m
        self.channel = channel % m
        self._taps = make_channelizer_taps(m, taps_per_phase)
        self._st = channelizer_init_state(m, taps_per_phase)

    def read(self, nblocks: int) -> np.ndarray:
        from fm_radio.parallel.channelizer import channelize_packed
        from fm_radio.utils.transfer import pack_iq_u8

        m = self.channels
        want = 2 * m * self.block * nblocks
        raw = self._fh.read(want)
        n = (len(raw) // (2 * m)) * (2 * m)
        if n == 0:
            return np.zeros(0, np.complex64)
        w = pack_iq_u8(np.frombuffer(raw[:n], np.uint8).reshape(-1, 2))
        self._st, y = channelize_packed(self._taps, self._st, w, m)
        x = np.asarray(y)[self.channel] / m  # scale: see stream_selected
        return x[: (x.size // self.block) * self.block].astype(np.complex64)

    def set_channel(self, k: int) -> None:
        self.channel = k % self.channels


def run_monitor(args) -> None:
    """CLI driver: stream a pcm file (or stdin) and repaint the dashboard.

    Interactive when a controlling tty exists: single keys mutate the LIVE
    pipeline (audio mode, L±R cutoffs, L−R gain, de-emphasis) through
    :class:`ControlSurface` — the runtime-control parity of the reference
    GUI's demod panel (``render_fm_demod.cpp:305-374``).  With
    ``--wideband M`` the input is an M-channel wideband capture: the
    filterbank extracts one station and 'n'/'N' retune to the next/previous
    station live (DeviceSelector + retune parity)."""
    from fm_radio.io.player import PCMPlayer, PlayerSinkError
    from fm_radio.models.app import App

    player = None
    if getattr(args, "play", None):
        if args.play == "-":
            sys.exit("monitor --play needs a command (stdout shows the "
                     "dashboard); e.g. --play 'aplay -f FLOAT_LE -r 48000 -c 2'")
        player = PCMPlayer(command=args.play,
                           fmt=getattr(args, "play_format", "f32"))

    def fresh_chain():
        app = App(block_size=args.block, channels=1,
                  rds_backend=getattr(args, "rds_backend", "python"))
        mon = Monitor(app, mode=args.mode, block_size=args.block,
                      on_audio=player.consume if player else None)
        return app, mon, ControlSurface(app.demod)

    app, mon, controls = fresh_chain()
    keys = _KeyReader()
    last_action = ""

    from_file = args.input not in (None, "-")
    fh = open(args.input, "rb") if from_file else sys.stdin.buffer
    wideband_m = int(getattr(args, "wideband", 0) or 0)
    if wideband_m > 1:
        source = _WidebandSource(fh, args.block, wideband_m,
                                 channel=int(getattr(args, "channel", 0)))
    else:
        source = _FileSource(fh, args.block)
    use_ansi = (not args.no_ansi) and sys.stdout.isatty()
    frames = 0
    try:
        while args.frames is None or frames < args.frames:
            ch = keys.poll()
            if ch == "q":
                break
            if ch == "v":
                last_action = f"spectra -> {mon.cycle_spectrum_mode()}"
            elif ch == "p":
                last_action = f"page -> {mon.toggle_page()}"
            elif ch in ("n", "N") and source.channels > 1:
                # retune: pick the neighboring station; the demod chain
                # restarts cold exactly like the reference after a retune
                page = mon.page
                source.set_channel(source.channel + (1 if ch == "n" else -1))
                app, mon, controls = fresh_chain()
                mon.page = page
                last_action = f"station -> channel {source.channel}"
            elif ch is not None:
                msg = controls.handle_key(ch)
                if msg is not None:
                    last_action = msg
            x = source.read(args.refresh)
            nb = x.size // args.block
            if nb == 0:
                break
            try:
                for b in range(nb):
                    mon.step(x[b * args.block:(b + 1) * args.block],
                             with_taps=(b == nb - 1))
            except PlayerSinkError as e:
                sys.exit(f"--play: {e}")
            frame = render_frame(mon.snapshot(), width=args.width,
                                 ascii_only=args.no_ansi)
            footer = controls.status_line()
            if source.channels > 1:
                footer += (f"   station: channel {source.channel}"
                           f"/{source.channels} (n/N retune)")
            if last_action:
                footer += f"   [{last_action}]"
            footer += "\n" + ControlSurface.HELP
            if use_ansi:
                sys.stdout.write("\x1b[H\x1b[2J" + frame + "\n" + footer + "\n")
            else:
                sys.stdout.write(frame + "\n" + footer + "\n\n")
            sys.stdout.flush()
            frames += 1
    finally:
        keys.close()
        if player is not None:
            player.close()
        if from_file:
            fh.close()
