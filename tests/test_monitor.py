"""Monitor dashboard tests: pure renderer units + a CLI smoke run.

The monitor is the framework's GUI-parity surface (SURVEY.md §2.8): it must
show live spectra, pilot lock, the BPSK constellation, and the RDS database
from a stream — asserted here on a synthetic station.
"""

import numpy as np
import pytest

from fm_radio.apps.monitor import FrameStats, render_frame, scatter, spark


def test_spark_shape_and_ramp():
    line = spark(np.linspace(0.0, 1.0, 500), width=40, ascii_only=True)
    assert len(line) == 40
    # monotone input -> ramp ends hotter than it starts
    ramp = " .:-=+*#%@"
    assert ramp.index(line[-1]) > ramp.index(line[0])


def test_spark_empty_and_flat():
    assert spark(np.array([]), width=10) == " " * 10
    flat = spark(np.ones(64), width=16, ascii_only=True)
    assert len(flat) == 16  # no NaN/div-by-zero on zero span


def test_scatter_plots_points_on_grid():
    rows = scatter(np.array([0.0]), np.array([1.0]), width=21, height=9,
                   lim=1.5)
    assert len(rows) == 9 and all(len(r) == 21 for r in rows)
    # a point at +j lands above the horizontal axis, on the vertical axis
    joined = "\n".join(rows)
    assert "●" in joined
    upper = "\n".join(rows[: 9 // 2])
    assert "●" in upper


def test_render_frame_contains_all_panels():
    s = FrameStats(
        block_index=7,
        total_samples=7 * 65536,
        samples_per_s=2.048e6,
        spectra={"fm_in": np.linspace(0, 90, 128)},
        pll_phase_error_rms=0.01,
        pll_locked=True,
        audio_rms=(0.3, 0.3),
        bpsk_points=(np.array([0.1]), np.array([0.9])),
        symbols_seen=1234,
        groups_seen=5,
        rds={"pi": 0xBEEF, "ps": "FT", "rt": "hello", "pty_name": "Pop M",
             "ct": "12:34 01/02/2026", "flags": "stereo=1"},
        last_group_line="[group] [BEEF ...]",
        stage_ms={"demod": 5.0, "rds": 0.1},
    )
    frame = render_frame(s, width=48, ascii_only=True)
    for needle in ("block 7", "2.05 MS/s", "LOCKED", "BEEF", "'FT'",
                   "hello", "Pop M", "symbols      1234", "demod"):
        assert needle in frame, needle


def test_control_surface_keys_mutate_live_pipeline():
    """Live-control parity with the reference GUI demod panel
    (``render_fm_demod.cpp:305-374``): an injected keypress re-designs the
    running pipeline's coefficients mid-stream and the OUTPUT spectrum
    changes — here the 'l' key walks the L+R audio cutoff from 15 kHz down
    to 1 kHz and a 3 kHz mono test tone must vanish from the audio."""
    from fm_radio.apps.monitor import ControlSurface
    from fm_radio.io.synth import FMModulator, ModulatorConfig
    from fm_radio.models.app import App

    block = 16384
    mod = FMModulator(ModulatorConfig())
    iq = mod.generate(block * 4, left_hz=3000.0, right_hz=3000.0)

    def tone_db(app):
        app.audio_blocks.clear()
        app.process(iq)
        audio = np.concatenate([a[0] for a in app.audio_blocks], axis=0)
        mono = audio[audio.shape[0] // 2:, 0]  # settled half
        spec = np.abs(np.fft.rfft(mono * np.hanning(mono.size)))
        freqs = np.fft.rfftfreq(mono.size, 1.0 / app.demod.fs_audio)
        band = (freqs > 2800) & (freqs < 3200)
        return 20 * np.log10(spec[band].max() + 1e-12)

    app = App(block_size=block, channels=1, decode_rds=False)
    ctl = ControlSurface(app.demod)
    before = tone_db(app)

    for _ in range(20):  # 15k -> clamped floor 1k
        ctl.handle_key("l")
    assert app.demod.cfg.audio_lpr_cutoff_hz == 1000  # bound clamps
    after = tone_db(app)
    assert before - after > 20, (before, after)

    # restore and confirm the tone comes back (dirty-flag redesign is
    # symmetric; carried filter state survives the coefficient swap)
    for _ in range(20):
        ctl.handle_key("L")
    assert app.demod.cfg.audio_lpr_cutoff_hz == 15000
    assert tone_db(app) > after + 20


def test_control_surface_bindings_and_status():
    """Every bound key mutates exactly its control, respects reference
    bounds, and reports a human-readable action + status line."""
    from fm_radio.apps.monitor import ControlSurface
    from fm_radio.models.app import App

    app = App(block_size=4096, channels=1, decode_rds=False)
    ctl = ControlSurface(app.demod)
    cfg = app.demod.cfg

    assert ctl.handle_key("m") == "audio mode -> lpr"
    assert app.demod.cfg.audio_out == "lpr"
    ctl.handle_key("m"), ctl.handle_key("m")
    assert app.demod.cfg.audio_out == "stereo"  # full cycle

    assert "L-R gain" in ctl.handle_key("G")
    assert app.demod.cfg.audio_stereo_mix_factor == cfg.audio_stereo_mix_factor + 0.25
    for _ in range(30):
        ctl.handle_key("G")
    assert app.demod.cfg.audio_stereo_mix_factor == 5.0  # slider max

    assert ctl.handle_key("e") == "de-emphasis -> on"
    assert app.demod.cfg.use_deemphasis_filter
    ctl.handle_key("]")
    assert app.demod.cfg.deemphasis_cutoff_us == cfg.deemphasis_cutoff_us + 5
    for _ in range(40):
        ctl.handle_key("[")
    assert app.demod.cfg.deemphasis_cutoff_us == cfg.analog.tus_min_deemphasis

    assert ctl.handle_key("z") is None  # unbound key: inert
    # escape-sequence fragments and undecodable bytes must be inert too:
    # '' would match `ch in "gG"` (empty string is "in" everything) and
    # '[' arrives as the CSI byte of every arrow/function key
    g = app.demod.cfg.audio_stereo_mix_factor
    us = app.demod.cfg.deemphasis_cutoff_us
    assert ctl.handle_key("") is None
    assert ctl.handle_key("\x1b") is None
    assert ctl.handle_key("[A") is None  # multi-char fragment
    assert app.demod.cfg.audio_stereo_mix_factor == g
    assert app.demod.cfg.deemphasis_cutoff_us == us
    line = ctl.status_line()
    for needle in ("mode=stereo", "L+R cutoff", "deemph="):
        assert needle in line


def test_monitor_renders_all_seven_reference_spectra():
    """The reference GUI shows seven magnitude spectra
    (render_fm_demod.cpp:98-273); the dashboard must render all of them."""
    from fm_radio.apps.monitor import SPECTRUM_TAPS

    assert list(SPECTRUM_TAPS) == ["baseband", "fm_in", "fm_out", "pilot",
                                   "audio_lpr", "audio_lmr", "rds"]
    s = FrameStats(spectra={k: np.linspace(-80, 0, 64) for k in SPECTRUM_TAPS})
    frame = render_frame(s, width=48, ascii_only=True)
    for title in ("baseband (1.024 MHz)", "FM input (256 kHz)",
                  "FM output (128 kHz)", "pilot tone (128 kHz)",
                  "audio L+R (32 kHz)", "audio L-R (32 kHz)",
                  "RDS band (16 kHz)"):
        assert title in frame, title


def test_monitor_spectrum_mode_cycles_and_resets_views():
    from fm_radio.apps.monitor import Monitor
    from fm_radio.models.app import App

    app = App(block_size=4096, channels=1, decode_rds=False)
    mon = Monitor(app, mode="average", block_size=4096)
    assert mon.cycle_spectrum_mode() == "max_hold"
    assert mon.cycle_spectrum_mode() == "normal"
    assert mon.cycle_spectrum_mode() == "average"
    assert all(v.mode == "average" for v in mon.views.values())


def test_monitor_scope_page_renders_waveforms():
    """The 'p' page shows the GUI's time-domain plots
    (render_fm_demod.cpp:499-640) as waveform panels."""
    from fm_radio.apps.monitor import Monitor, SCOPE_PANELS
    from fm_radio.io.synth import FMModulator, ModulatorConfig
    from fm_radio.models.app import App

    app = App(block_size=16384, channels=1, decode_rds=True)
    mon = Monitor(app, block_size=16384)
    assert mon.toggle_page() == "scope"
    mod = FMModulator(ModulatorConfig())
    iq = mod.generate(16384, left_hz=1000.0, right_hz=400.0)
    mon.step(iq)
    stats = mon.snapshot()
    assert set(stats.scope) == {k for k, _ in SCOPE_PANELS}
    frame = render_frame(stats, width=48, ascii_only=True)
    for _, title in SCOPE_PANELS:
        assert title in frame, title
    assert "baseband (1.024 MHz)" not in frame  # spectra hidden on scope page
    assert mon.toggle_page() == "spectra"


def test_wideband_source_extracts_and_retunes(tmp_path):
    """_WidebandSource: filterbank-extract one station from a wideband
    capture and switch stations mid-stream — each decodes its OWN PI (the
    DeviceSelector + retune workflow, fm_demod_tuner.cpp:174-176)."""
    from fm_radio.apps.monitor import Monitor, _WidebandSource
    from fm_radio.io.pcm import c64_to_u8
    from fm_radio.io.synth import FMModulator, ModulatorConfig
    from fm_radio.models.app import App

    m, fs_ch, block = 4, 1_024_000, 16384
    n_ch = block * 80  # ~1.3 s/station: RDS lock (~0.45 s) + groups, twice
    n_wide = n_ch * m
    t_ax = np.arange(n_wide) / (fs_ch * m)
    wide = np.zeros(n_wide, np.complex64)
    for k, pi in ((1, 0x1111), (2, 0x2222)):
        mod = FMModulator(ModulatorConfig())
        groups = [(pi, (0 << 12) | (1 << 10), 0xE101, 0x4142)]
        iq = mod.generate(n_ch, left_hz=1000.0, right_hz=1000.0,
                          rds_groups=groups)
        wide += (np.repeat(iq, m)[:n_wide]
                 * np.exp(2j * np.pi * k * fs_ch * t_ax)).astype(np.complex64)
    wide /= np.abs(wide).max() / 100.0
    path = tmp_path / "wide.pcm"
    c64_to_u8(wide).tofile(path)

    def monitor_station(chan, blocks):
        app = App(block_size=block, channels=1)
        mon = Monitor(app, block_size=block)
        x = src.read(blocks)
        for b in range(x.size // block):
            mon.step(x[b * block:(b + 1) * block], with_taps=False)
        return app.rds_chains[0].db.pi_code

    with open(path, "rb") as fh:
        src = _WidebandSource(fh, block, m, channel=1)
        assert monitor_station(1, 38) == 0x1111
        src.set_channel(2)  # retune mid-stream: filterbank state carries
        assert monitor_station(2, 38) == 0x2222


@pytest.mark.slow
def test_monitor_cli_smoke(tmp_path):
    """End-to-end: monitor a synthetic station, expect pilot lock + PI."""
    import os
    import subprocess
    import sys

    from fm_radio.io.pcm import c64_to_u8
    from fm_radio.io.synth import FMModulator, ModulatorConfig

    block = 16384
    mod = FMModulator(ModulatorConfig())
    groups = [(0xBEEF, 0, 0x0000, 0x4654)]
    iq = mod.generate(block * 24, left_hz=1000.0, right_hz=400.0,
                      rds_groups=groups)
    path = tmp_path / "mon.pcm"
    c64_to_u8(iq).tofile(path)

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    out = subprocess.run(
        [sys.executable, "-m", "fm_radio.apps.cli", "monitor",
         "-i", str(path), "-b", str(block), "--refresh", "8",
         "--frames", "3", "--no-ansi"],
        capture_output=True, env=env, timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert out.returncode == 0, out.stderr.decode()
    text = out.stdout.decode()
    assert "pilot PLL: LOCKED" in text
    assert "PI           BEEF" in text
    assert "station: 'FT'" in text
    assert "stages/frame:" in text
