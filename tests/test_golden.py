"""Golden parity vs the REFERENCE IMPLEMENTATION (BASELINE configs 1-3).

Builds the unmodified reference demod chain (read-only at /root/reference,
GUI FFTs stubbed — tests/golden/) into a headless binary, runs both it and
this framework on the same synthetic recording, and asserts:
  * stereo audio agreement (SNR bound, config 1/2),
  * bit-exact RDS byte stream (config 3),
  * group-level decode agreement (PI / text fields).
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

from fm_radio.io.pcm import c64_to_u8, u8_to_c64
from fm_radio.io.synth import FMModulator, ModulatorConfig
from fm_radio.models.app import App

BLOCK = 65536
REF = os.environ.get("REF", "/root/reference")

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None or not os.path.isdir(REF),
    reason="reference tree or g++ unavailable",
)


@pytest.fixture(scope="module")
def golden_binary(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("golden") / "golden_demod")
    script = os.path.join(os.path.dirname(__file__), "golden", "build.sh")
    r = subprocess.run(["sh", script, out], capture_output=True, timeout=300)
    if r.returncode != 0:
        pytest.skip(f"reference build failed: {r.stderr.decode()[:500]}")
    return out


@pytest.fixture(scope="module")
def run_pair(golden_binary, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("io")
    mod = FMModulator(ModulatorConfig())
    groups = [
        (0x1234, (0 << 12) | (1 << 10), 0xE101, 0x4142),
        (0x1234, (2 << 12), 0x4845, 0x4C4C),
    ]
    iq = mod.generate(BLOCK * 10, left_hz=1000.0, right_hz=3000.0, rds_groups=groups)
    u8 = c64_to_u8(iq)
    pcm = str(tmp / "in.pcm")
    u8.tofile(pcm)

    audio_f = str(tmp / "audio.f32")
    rds_f = str(tmp / "rds.bin")
    r = subprocess.run(
        [golden_binary, pcm, audio_f, rds_f, str(BLOCK)],
        capture_output=True,
        timeout=300,
    )
    assert r.returncode == 0, r.stderr.decode()[:500]
    golden_audio = np.fromfile(audio_f, dtype=np.float32).reshape(-1, 2)
    golden_rds = np.fromfile(rds_f, dtype=np.uint8)
    golden_log = r.stderr.decode()

    app = App(block_size=BLOCK, channels=1, decode_rds=True)
    app.process(u8_to_c64(u8))
    return golden_audio, golden_rds, golden_log, app


def test_audio_matches_reference_binary(run_pair):
    golden_audio, _, _, app = run_pair
    ours = app.audio[0]
    assert ours.shape == golden_audio.shape
    settle = 32000 // 5  # skip the mutual lock-in transient
    d = ours[settle:] - golden_audio[settle:]
    snr = 10 * np.log10(
        (golden_audio[settle:] ** 2).sum() / ((d**2).sum() + 1e-20)
    )
    print(f"golden audio SNR vs reference: {snr:.1f} dB")
    # measured ~83 dB; anything above 60 dB is far inside the reference's own
    # -ffast-math float noise
    assert snr > 60.0, f"audio SNR vs reference only {snr:.1f} dB"


def test_rds_bytes_bit_exact(run_pair):
    _, golden_rds, _, app = run_pair
    ours = app.rds_bytes(0)
    assert len(ours) > 0
    np.testing.assert_array_equal(ours, golden_rds[: len(ours)])
    # at most one trailing 16-byte buffer difference (emission granularity)
    assert abs(len(golden_rds) - len(ours)) <= 16


def test_group_decode_matches_reference_log(run_pair):
    _, _, golden_log, app = run_pair
    assert "PI=1234" in golden_log
    db = app.rds_database(0)
    assert db.pi_code == 0x1234
    # the reference decoded RadioText 'HELL...' — so must we
    assert "text='HELL'" in golden_log
    assert db.radio_text_str.startswith("HELL")
    # our log lines carry the same group words as the reference's
    ref_groups = {
        line.split("[group] [")[1].split("]")[0]
        for line in golden_log.splitlines()
        if "[group] [" in line
    }
    our_groups = {
        line.split("[group] [")[1].split("]")[0]
        for line in app.rds_log_lines(0)
        if "[group] [" in line
    }
    assert our_groups, "no groups decoded"
    assert our_groups <= ref_groups or ref_groups <= our_groups


def test_strict_ref_b_groups_log_parity(golden_binary, tmp_path):
    """Config-3 extension with VERSION-B groups in the stream: the reference
    prints ``Unsupported_Code`` for every B group (rds_decoder.cpp:146-155).
    In ``strict_ref`` mode our log lines must equal the reference's exactly;
    in default mode the same groups must be DECODED (0B/2B/15B superset)."""
    groups = [
        (0x1234, (0 << 12) | (1 << 10) | 0b01, 0xE101, 0x4142),  # 0A
        (0x1234, (0 << 12) | (1 << 11) | 0b10, 0x1234, 0x4644),  # 0B seg2 'FD'
        (0x1234, (2 << 12) | (1 << 11) | 0x3, 0x1234, 0x4849),   # 2B 'HI'
        (0x1234, (15 << 12) | (1 << 11) | 0b01, 0x1234,
         (15 << 12) | (1 << 11) | 0b01),                          # 15B
        (0x1234, (2 << 12), 0x4845, 0x4C4C),                      # 2A
    ]
    mod = FMModulator(ModulatorConfig())
    iq = mod.generate(BLOCK * 10, left_hz=1000.0, right_hz=3000.0,
                      rds_groups=groups)
    u8 = c64_to_u8(iq)
    pcm = str(tmp_path / "in.pcm")
    u8.tofile(pcm)

    audio_f = str(tmp_path / "audio.f32")
    rds_f = str(tmp_path / "rds.bin")
    r = subprocess.run(
        [golden_binary, pcm, audio_f, rds_f, str(BLOCK)],
        capture_output=True,
        timeout=300,
    )
    assert r.returncode == 0, r.stderr.decode()[:500]
    prefix = "[rds_decoder] "
    ref_lines = [
        ln[len(prefix):]
        for ln in r.stderr.decode().splitlines()
        if ln.startswith(prefix) and "[group] [" in ln
    ]
    assert any("B," in ln[:60].split("Type")[-1] and "Unsupported_Code" in ln
               for ln in ref_lines), "reference saw no B groups — bad fixture"

    app_strict = App(block_size=BLOCK, channels=1, decode_rds=True,
                     strict_ref=True)
    app_strict.process(u8_to_c64(u8))
    ours_strict = app_strict.rds_log_lines(0)
    assert ours_strict, "strict app decoded no groups"
    # identical RDS bytes (asserted by test_rds_bytes_bit_exact's machinery)
    # feed a deterministic group sync: line-for-line equality modulo the one
    # trailing 16-byte emission-granularity buffer
    ref_set = set(ref_lines)
    missing = [ln for ln in ours_strict if ln not in ref_set]
    assert not missing, f"strict-mode lines absent from reference log: {missing[:3]}"
    assert len(ref_lines) - len(ours_strict) <= 2

    # default (superset) mode: the same B groups DECODE instead
    app_super = App(block_size=BLOCK, channels=1, decode_rds=True)
    app_super.process(u8_to_c64(u8))
    ours_super = app_super.rds_log_lines(0)
    b_lines = [ln for ln in ours_super
               if "Type  0B" in ln or "Type  2B" in ln or "Type 15B" in ln]
    assert b_lines and all("Unsupported_Code" not in ln for ln in b_lines)
    db = app_super.rds_database(0)
    assert db.radio_text_str.startswith("HI") or "HI" in db.radio_text_str


@pytest.mark.parametrize(
    "mode,gain,lpr_hz,lmr_hz,deemph_us",
    [
        ("lmr", 1.0, 0, 0, 0),             # L-R only output path
        ("lpr", 1.0, 8000, 0, 75),         # L+R only + cutoff + de-emphasis
        ("stereo", 2.5, 12000, 9000, 0),   # gain + both cutoffs
    ],
    ids=["lmr-mode", "lpr-cutoff-deemph", "stereo-gain-cutoffs"],
)
def test_controls_match_reference_binary(golden_binary, tmp_path,
                                         mode, gain, lpr_hz, lmr_hz,
                                         deemph_us):
    """Runtime-control golden parity: the full GUI demod-panel control set
    (audio mode, L-R gain, L+/-R cutoffs, de-emphasis —
    render_fm_demod.cpp:305-374) applied identically to the reference binary
    and to this framework must produce the same audio.  This pins the
    control surface this framework exposes as CLI flags and live monitor
    keys to the reference at the signal level."""
    import dataclasses

    from fm_radio.config import DemodConfig

    mod = FMModulator(ModulatorConfig())
    iq = mod.generate(BLOCK * 8, left_hz=1000.0, right_hz=3000.0)
    u8 = c64_to_u8(iq)
    pcm = str(tmp_path / "in.pcm")
    u8.tofile(pcm)

    audio_f = str(tmp_path / "audio.f32")
    rds_f = str(tmp_path / "rds.bin")
    r = subprocess.run(
        [golden_binary, pcm, audio_f, rds_f, str(BLOCK),
         str(deemph_us), mode, str(gain),
         str(lpr_hz or 0), str(lmr_hz or 0)],
        capture_output=True,
        timeout=300,
    )
    assert r.returncode == 0, r.stderr.decode()[:500]
    golden_audio = np.fromfile(audio_f, dtype=np.float32).reshape(-1, 2)

    changes = {"audio_out": mode, "audio_stereo_mix_factor": gain}
    if deemph_us:
        changes.update(use_deemphasis_filter=True,
                       deemphasis_cutoff_us=deemph_us)
    if lpr_hz:
        changes["audio_lpr_cutoff_hz"] = lpr_hz
    if lmr_hz:
        changes["audio_lmr_cutoff_hz"] = lmr_hz
    cfg = dataclasses.replace(DemodConfig(), **changes)
    app = App(block_size=BLOCK, cfg=cfg, channels=1, decode_rds=False)
    app.process(u8_to_c64(u8))
    ours = app.audio[0]
    assert ours.shape == golden_audio.shape

    settle = 32000 // 5
    d = ours[settle:] - golden_audio[settle:]
    snr = 10 * np.log10(
        (golden_audio[settle:] ** 2).sum() / ((d**2).sum() + 1e-20))
    print(f"controls [{mode} g={gain} lpr={lpr_hz} lmr={lmr_hz} "
          f"de={deemph_us}] SNR vs reference: {snr:.1f} dB")
    assert snr > 60.0, f"SNR vs reference only {snr:.1f} dB"


def test_audio_matches_reference_with_deemphasis(golden_binary, tmp_path):
    """Config-2 extension: the de-emphasis IIR path (off by default in both
    implementations) compared against the reference with Tus=50."""
    from dataclasses import replace

    from fm_radio.config import DemodConfig

    mod = FMModulator(ModulatorConfig())
    iq = mod.generate(BLOCK * 8, left_hz=1000.0, right_hz=6000.0)
    u8 = c64_to_u8(iq)
    pcm = str(tmp_path / "in.pcm")
    u8.tofile(pcm)

    audio_f = str(tmp_path / "audio.f32")
    rds_f = str(tmp_path / "rds.bin")
    r = subprocess.run(
        [golden_binary, pcm, audio_f, rds_f, str(BLOCK), "50"],
        capture_output=True,
        timeout=300,
    )
    assert r.returncode == 0, r.stderr.decode()[:500]
    golden_audio = np.fromfile(audio_f, dtype=np.float32).reshape(-1, 2)

    cfg = replace(
        DemodConfig(), use_deemphasis_filter=True, deemphasis_cutoff_us=50
    )
    app = App(block_size=BLOCK, cfg=cfg, channels=1, decode_rds=False)
    app.process(u8_to_c64(u8))
    ours = app.audio[0]
    assert ours.shape == golden_audio.shape

    settle = 32000 // 5
    d = ours[settle:] - golden_audio[settle:]
    snr = 10 * np.log10((golden_audio[settle:] ** 2).sum() / ((d**2).sum() + 1e-20))
    print(f"golden audio SNR (deemphasis 50us): {snr:.1f} dB")
    assert snr > 60.0, f"deemphasis-path SNR vs reference only {snr:.1f} dB"
