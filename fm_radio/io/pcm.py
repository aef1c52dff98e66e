"""Recorded-IQ (*.pcm) reading: interleaved u8 I/Q at Fs_baseband.

Parity: the file path of ``fm_demod_no_tuner`` / ``fm_demod_benchmark``
(``fm_demod_no_tuner.cpp:179-189``): fread blocks of complex<u8>, recenter by
-127 (``app.cpp:57-63``).  Reading uses a zero-copy memmap; the u8->f32
recenter happens on device as part of the jitted block (the host->device
transfer stays 2 bytes/sample).
"""

from __future__ import annotations

import numpy as np


def read_pcm_u8(path: str, max_samples: int | None = None) -> np.ndarray:
    """Read interleaved u8 IQ -> [N] array of raw (I, Q) u8 pairs [N, 2]."""
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    n = raw.size // 2
    if max_samples is not None:
        n = min(n, max_samples)
    return np.asarray(raw[: 2 * n]).reshape(n, 2)


def u8_to_c64(iq_u8: np.ndarray) -> np.ndarray:
    """Recenter: (u8 - 127) + j(u8 - 127)  (app.cpp:57-63)."""
    f = iq_u8.astype(np.float32) - 127.0
    return (f[..., 0] + 1j * f[..., 1]).astype(np.complex64)


def c64_to_u8(x: np.ndarray) -> np.ndarray:
    """Quantize centered complex IQ back to interleaved u8 (for synthesizing
    reference-format recordings)."""
    out = np.empty(x.shape + (2,), dtype=np.uint8)
    out[..., 0] = np.clip(np.round(x.real + 127.0), 0, 255).astype(np.uint8)
    out[..., 1] = np.clip(np.round(x.imag + 127.0), 0, 255).astype(np.uint8)
    return out


def iter_pcm_blocks(path: str, block_size: int, max_blocks: int | None = None):
    """Yield [block_size] complex64 centered blocks; drops the final partial
    block like the reference's fread loop (fm_demod_benchmark.cpp:96-99)."""
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    n_blocks = raw.size // (2 * block_size)
    if max_blocks is not None:
        n_blocks = min(n_blocks, max_blocks)
    for b in range(n_blocks):
        chunk = np.asarray(
            raw[b * 2 * block_size : (b + 1) * 2 * block_size], dtype=np.uint8
        ).reshape(block_size, 2)
        yield u8_to_c64(chunk)


class LazyPackedPcm:
    """Constant-memory packed-word view of a u8 IQ capture on disk.

    Quacks like the array ``pack_iq_u8(whole_file)`` for the two operations
    the wideband streaming loop needs — ``len()`` and contiguous slicing —
    but packs each requested chunk on demand from a byte ``memmap``, so an
    arbitrarily long capture (hours of multi-channel wideband) streams
    through ``stream_selected`` / ``fmtpu stations`` in O(chunk) host
    memory instead of 4 bytes x every sample up front.
    """

    def __init__(self, path: str, max_samples: int | None = None):
        from fm_radio.utils.transfer import pack_iq_u8

        self._pack = pack_iq_u8
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        self._n = self._mm.size // 2
        if max_samples is not None:
            self._n = min(self._n, max_samples)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, sl: slice) -> np.ndarray:
        start, stop, step = sl.indices(self._n)
        assert step == 1, "LazyPackedPcm supports contiguous slices only"
        chunk = np.asarray(self._mm[2 * start : 2 * stop]).reshape(-1, 2)
        return self._pack(chunk)


class LazyI8Pcm:
    """Constant-memory int8-plane view of a u8 IQ capture on disk.

    Like :class:`LazyPackedPcm` but in the default ingest format
    (utils/transfer.split_iq_i8): slices come back as [2, 1, M] int8 planes
    of (I-128, Q-128) — 2 bytes per complex sample on the host->device link
    and in device memory, HALF the packed-word form.
    Single-channel (the ``fmtpu demod``/``scrape`` shape); ``len()`` counts
    complex samples.
    """

    def __init__(self, path: str, max_samples: int | None = None):
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        self._n = self._mm.size // 2
        if max_samples is not None:
            self._n = min(self._n, max_samples)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, sl: slice) -> np.ndarray:
        from fm_radio.utils.transfer import split_iq_i8

        start, stop, step = sl.indices(self._n)
        assert step == 1, "LazyI8Pcm supports contiguous slices only"
        chunk = np.asarray(self._mm[2 * start : 2 * stop]).reshape(-1, 2)
        return split_iq_i8(chunk)[:, None, :]
