"""RDS decoding chain wiring: group_sync -> decoder -> db_handler -> database.

Parity: ``RDS_Decoding_Chain`` (``src/rds_decoder/rds_decoding_chain.h:8-32``).
"""

from __future__ import annotations

import numpy as np

from fm_radio.rds.database import RDSDatabase, RDSDatabaseHandler
from fm_radio.rds.decoder import RDSDecoder
from fm_radio.rds.group_sync import RDSGroupSync
from fm_radio.rds.manchester import DifferentialManchesterDecoder


class RDSDecodingChain:
    def __init__(self, on_group=None, strict_ref: bool = False,
                 fast_resync: bool = False):
        self.db = RDSDatabase()
        self.db_handler = RDSDatabaseHandler(self.db)
        self.decoder = RDSDecoder(self.db_handler, strict_ref=strict_ref)
        self.log_lines: list[str] = []
        self.groups: list = []
        self._user_on_group = on_group
        self.group_sync = RDSGroupSync(on_group=self._handle_group,
                                       fast_resync=fast_resync)

    def _handle_group(self, group) -> None:
        self.groups.append(group)
        self.log_lines.append(self.decoder.process_group(group))
        if self._user_on_group is not None:
            self._user_on_group(group)

    def process(self, data: np.ndarray) -> None:
        """data: bytes from the Manchester decoder."""
        self.group_sync.process_bytes(data)


class RDSFullChain:
    """Symbols -> database: Manchester + decoding chain, as wired by ``App``
    (``app.cpp:23-34``)."""

    def __init__(self, strict_ref: bool = False, fast_resync: bool = False):
        self.chain = RDSDecodingChain(strict_ref=strict_ref,
                                      fast_resync=fast_resync)
        self.rds_bytes: list[np.ndarray] = []
        self.manchester = DifferentialManchesterDecoder(
            buf_size=16, on_bytes=self._on_bytes
        )

    def _on_bytes(self, buf: np.ndarray) -> None:
        self.rds_bytes.append(buf.copy())
        self.chain.process(buf)

    def process_symbols(self, soft_symbols: np.ndarray) -> None:
        self.manchester.process(soft_symbols)

    @property
    def db(self) -> RDSDatabase:
        return self.chain.db


class NativeRDSFullChain:
    """``RDSFullChain`` drop-in backed by the NATIVE Manchester + group-sync
    state machines (runtime/fmtpu_runtime.cpp) — the serving fast path for
    high channel counts (SCALING.md "What is deliberately NOT distributed"):
    the bit-serial hot loops run in C++, group-type decode + database stay
    in Python (identical log lines / database semantics).

    Byte-stream artifacts (``rds_bytes``) are not produced on this path —
    use the Python chain (the scrape artifact path) when byte-level parity
    with fm_demod_scraper is required.
    """

    def __init__(self, strict_ref: bool = False):
        from fm_radio import runtime as rt
        from fm_radio.rds.group_sync import RDSBlock

        self._RDSBlock = RDSBlock
        self._native = rt.NativeRDSBitDecoder()
        # reuse decoder/db/log plumbing
        self.chain = RDSDecodingChain(strict_ref=strict_ref)
        self.rds_bytes: list[np.ndarray] = []

    def process_symbols(self, soft_symbols: np.ndarray) -> None:
        for g in self._native.process_symbols(soft_symbols):
            blocks = [
                self._RDSBlock(data=d, block_type=t, is_valid=v)
                for d, t, v in zip(g["data"], g["types"], g["valid"])
            ]
            self.chain.groups.append(blocks)
            line = self.chain.decoder.process_group(blocks)
            self.chain.log_lines.append(line)

    @property
    def db(self) -> RDSDatabase:
        return self.chain.db


def make_rds_chain(backend: str = "python", strict_ref: bool = False):
    """Chain factory: "python" (byte-artifact parity) or "native" (C++ bit
    loops; falls back to Python if the runtime library is unavailable)."""
    if backend == "native":
        from fm_radio import runtime as rt

        if rt.available():
            return NativeRDSFullChain(strict_ref=strict_ref)
    return RDSFullChain(strict_ref=strict_ref)
