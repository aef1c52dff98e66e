"""FM_Scraper artifact-lifecycle parity (``src/fm_scraper.cpp``):
timestamped names, WAV rotation on sample-rate change, lazy RDS open,
incremental header updates."""

import os
import re
import struct

import numpy as np

from fm_radio.io.scraper import (
    FMScraper,
    IncrementalWavWriter,
    reference_time_string,
)
from fm_radio.io.wav import read_wav_int16, write_wav_int16

RNG = np.random.default_rng(7)


def test_reference_time_string_format():
    s = reference_time_string(0.0)  # epoch, local time
    assert re.fullmatch(r"\d{4}-\d{2}-\d{2}T\d{2}-\d{2}-\d{2}", s)


def test_incremental_wav_matches_batch_writer(tmp_path):
    audio = (RNG.standard_normal((1000, 2)) * 0.2).astype(np.float32)
    inc = str(tmp_path / "inc.wav")
    w = IncrementalWavWriter(inc, 32000)
    for i in range(0, 1000, 96):  # odd chunking
        w.write(audio[i : i + 96])
    w.close()
    batch = str(tmp_path / "batch.wav")
    write_wav_int16(batch, audio, 32000)
    assert open(inc, "rb").read() == open(batch, "rb").read()


def test_incremental_wav_header_valid_after_every_write(tmp_path):
    path = str(tmp_path / "x.wav")
    w = IncrementalWavWriter(path, 32000)
    for n in (10, 20, 30):
        w.write(np.zeros((n, 2), np.float32))
        # header must be consistent mid-stream (fm_scraper.cpp:155-167):
        # a truncated capture is still a playable WAV
        blob = open(path, "rb").read()
        riff = struct.unpack("<i", blob[4:8])[0]
        data = struct.unpack("<i", blob[40:44])[0]
        assert riff == 36 + data
    w.close()
    got, fs = read_wav_int16(path)
    assert fs == 32000 and got.shape == (60, 2)


def test_scraper_rotates_wav_on_sample_rate_change(tmp_path):
    times = iter([1_000_000.0, 1_000_001.0, 1_000_002.0])
    sc = FMScraper(str(tmp_path), now_fn=lambda: next(times))
    a32 = (RNG.standard_normal((64, 2)) * 0.1).astype(np.float32)
    a48 = (RNG.standard_normal((96, 2)) * 0.1).astype(np.float32)
    sc.on_audio_data(a32, 32000)
    sc.on_audio_data(a32, 32000)  # same rate: same file
    sc.on_audio_data(a48, 48000)  # rate change: NEW timestamped file
    sc.close()
    assert len(sc.wav_paths) == 2
    g0, fs0 = read_wav_int16(sc.wav_paths[0])
    g1, fs1 = read_wav_int16(sc.wav_paths[1])
    assert fs0 == 32000 and g0.shape[0] == 128
    assert fs1 == 48000 and g1.shape[0] == 96
    for p in sc.wav_paths:
        assert re.fullmatch(
            r"\d{4}-\d{2}-\d{2}T\d{2}-\d{2}-\d{2}_audio\.wav",
            os.path.basename(p),
        )


def test_scraper_rds_file_is_lazy_and_timestamped(tmp_path):
    sc = FMScraper(str(tmp_path), now_fn=lambda: 1_000_000.0)
    assert sc.rds_path is None  # nothing until first bytes (fm_scraper.cpp:180)
    sc.on_rds_bytes(np.arange(16, dtype=np.uint8))
    sc.on_rds_bytes(np.arange(16, 32, dtype=np.uint8))
    sc.close()
    assert re.fullmatch(
        r"\d{4}-\d{2}-\d{2}T\d{2}-\d{2}-\d{2}_rds\.bin",
        os.path.basename(sc.rds_path),
    )
    np.testing.assert_array_equal(
        np.fromfile(sc.rds_path, dtype=np.uint8), np.arange(32, dtype=np.uint8)
    )


def test_incremental_wav_header_clamps_past_4gib(tmp_path):
    """Past-4GiB captures clamp the u32 RIFF sizes instead of crashing the
    live scrape with struct.error (signed '<i' died at 2 GiB)."""
    path = str(tmp_path / "big.wav")
    w = IncrementalWavWriter(path, 32000)
    w._data_bytes = 0xFFFFFFF0  # simulate ~4 GiB already written
    w.write(np.zeros((64, 2), np.float32))  # must not raise
    w.close()
    blob = open(path, "rb").read(44)
    riff = struct.unpack("<I", blob[4:8])[0]
    data = struct.unpack("<I", blob[40:44])[0]
    assert riff == data == 0xFFFFFFFF
