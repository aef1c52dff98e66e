"""Application orchestration: IQ bytes in -> audio + RDS database out.

Parity: ``App`` (``src/app.{h,cpp}``): re-blocks arbitrary input chunks to
exactly ``block_size`` (ReconstructionBuffer), recenters u8 IQ by -127, runs
the demodulator, and feeds RDS symbols through Manchester -> group sync ->
decoder -> database.  Batched channels each own an independent RDS chain.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from fm_radio.config import DemodConfig
from fm_radio.models.demod import (
    BroadcastFMDemod,
    demod_block,
    demod_init_state,
    make_coeffs,
)
from fm_radio.rds.chain import RDSFullChain


class App:
    def __init__(
        self,
        block_size: int = 65536,
        cfg: DemodConfig = DemodConfig(),
        channels: int = 1,
        decode_rds: bool = True,
        rds_backend: str = "python",
        strict_ref: bool = False,
    ):
        self.block_size = block_size
        self.channels = channels
        self.demod = BroadcastFMDemod(cfg, channels)
        self.decode_rds = decode_rds
        from fm_radio.rds.chain import make_rds_chain

        self.rds_chains = (
            [make_rds_chain(rds_backend, strict_ref=strict_ref)
             for _ in range(channels)]
            if decode_rds
            else []
        )
        self._pending = np.zeros((channels, 0), dtype=np.complex64)
        self.audio_blocks: list[np.ndarray] = []

    @property
    def cfg(self) -> DemodConfig:
        """The live config — delegates to the demodulator so runtime control
        changes (``demod.update_controls``) are never shadowed by a stale
        App-level copy."""
        return self.demod.cfg

    # -- input paths -------------------------------------------------------

    def _match_pending(self, x: np.ndarray) -> np.ndarray:
        """Pending re-block buffer in the stream's dtype (complex64 baseband,
        f32 packed words, or [2, C, N] int8 planes — a stream keeps ONE
        format throughout)."""
        if self._pending.dtype != x.dtype or self._pending.ndim != x.ndim:
            if self._pending.size:
                raise ValueError(
                    "input format changed mid-stream with samples pending "
                    f"({self._pending.dtype} -> {x.dtype}); a stream must "
                    "keep one format (complex64 baseband, f32 packed words, "
                    "or int8 planes)"
                )
            shape = ((2, self.channels, 0) if x.ndim == 3
                     else (self.channels, 0))
            self._pending = np.zeros(shape, x.dtype)
        return self._pending

    def process_u8(self, iq_u8: np.ndarray) -> None:
        """iq_u8: [N, 2] raw interleaved bytes (single channel) or
        [C, N, 2]."""
        f = iq_u8.astype(np.float32) - 127.0
        x = (f[..., 0] + 1j * f[..., 1]).astype(np.complex64)
        self.process(x)

    def process(self, x: np.ndarray) -> None:
        """x: [N] or [C, N] centered complex64, f32 packed u8 IQ words
        (utils/transfer.pack_iq_u8), or [2, C, N] int8 planes
        (utils/transfer.split_iq_i8 — the smallest ingest).  Re-blocks
        internally (reconstruction_buffer.h:16-26)."""
        if x.ndim == 1:
            x = x[None, :]
        buf = np.concatenate([self._match_pending(x), x], axis=-1)
        n_blocks = buf.shape[-1] // self.block_size
        for b in range(n_blocks):
            blk = buf[..., b * self.block_size : (b + 1) * self.block_size]
            self._run_block(blk)
        self._pending = buf[..., n_blocks * self.block_size :]

    def process_all(self, x: np.ndarray) -> None:
        """Batch fast path: identical outputs to :meth:`process`, but all
        complete blocks run as ONE device dispatch (``demod_stream`` lax.scan)
        — per-dispatch latency is paid once per call instead of once per
        block.  Worth it when the (n_blocks, block_size) shape is reused
        across calls (production streaming); a ONE-SHOT call at a fresh shape
        pays a long scan compile, so the CLI sticks to :meth:`process`."""
        if x.ndim == 1:
            x = x[None, :]
        buf = (
            np.concatenate([self._match_pending(x), x], axis=-1)
            if self._pending.size
            else np.asarray(x)
        )
        n_blocks = buf.shape[-1] // self.block_size
        if n_blocks == 0:
            self._pending = buf
            return
        t = n_blocks * self.block_size
        final_state, outs = demod_stream(
            self.demod.cfg,  # demod.cfg tracks update_controls; self.cfg doesn't
            np.ascontiguousarray(buf[..., :t]),
            self.block_size,
            state=self.demod.state,
            coeffs=self.demod.coeffs,
        )
        self.demod.state = final_state
        from fm_radio.utils.transfer import fetch

        audio = fetch(outs["audio"])
        self.audio_blocks.append(audio)
        if self.decode_rds:
            pred = fetch(outs["rds_pred"])
            valid = fetch(outs["rds_valid"])
            for c in range(self.channels):
                sym = pred[c][valid[c]]
                if sym.size:
                    self.rds_chains[c].process_symbols(sym)
        self._pending = buf[..., t:]

    # -- core --------------------------------------------------------------

    def _run_block(self, blk: np.ndarray) -> None:
        outs = self.demod.process(blk)
        self.audio_blocks.append(outs["audio"])
        if self.decode_rds:
            pred = outs["rds_pred"]
            valid = outs["rds_valid"]
            for c in range(self.channels):
                sym = pred[c][valid[c]]
                if sym.size:
                    self.rds_chains[c].process_symbols(sym)

    # -- outputs -----------------------------------------------------------

    @property
    def audio(self) -> np.ndarray:
        """[C, T_audio, 2] concatenated output audio."""
        if not self.audio_blocks:
            return np.zeros((self.channels, 0, 2), np.float32)
        return np.concatenate(self.audio_blocks, axis=1)

    def drain(self) -> dict:
        """Detach and return everything accumulated since the last drain,
        leaving the demod carry state, RDS sync state, and the databases
        intact.  The bounded-memory consumption API for long-running
        serving (tools/soak.py): without draining, ``audio_blocks`` /
        ``rds_bytes`` / group logs grow without bound (the reference
        streams into fixed ring buffers instead, ring_buffer.h:77-135).

        Returns {"audio": [C, T, 2], "rds_bytes": [C arrays],
        "log_lines": [C lists of new group log lines]}.
        """
        audio = self.audio
        self.audio_blocks.clear()
        rds_bytes, log_lines = [], []
        for c, ch in enumerate(self.rds_chains):
            rds_bytes.append(self.rds_bytes(c))
            ch.rds_bytes.clear()
            log_lines.append(list(ch.chain.log_lines))
            ch.chain.log_lines.clear()
            ch.chain.groups.clear()
        return {"audio": audio, "rds_bytes": rds_bytes,
                "log_lines": log_lines}

    def rds_database(self, channel: int = 0):
        return self.rds_chains[channel].db

    def rds_bytes(self, channel: int = 0) -> np.ndarray:
        bufs = self.rds_chains[channel].rds_bytes
        return np.concatenate(bufs) if bufs else np.zeros(0, np.uint8)

    def rds_log_lines(self, channel: int = 0) -> list[str]:
        return self.rds_chains[channel].chain.log_lines


def demod_stream(
    cfg: DemodConfig,
    x: np.ndarray,
    block_size: int = 65536,
    state: dict | None = None,
    coeffs: dict | None = None,
):
    """Whole-stream demodulation in ONE device call: ``lax.scan`` over blocks.

    x: [C, T] complex64 — or [C, T] REAL f32 of packed u8 IQ words
    (utils/transfer.pack_iq_u8; half the transfer and device-memory bytes,
    unpacked exactly on the device) — or [2, C, T] int8 (I-128, Q-128)
    planes (utils/transfer.split_iq_i8; half the bytes AGAIN).
    T a multiple of block_size.  Returns (final_state, outs) where outs
    arrays have a leading block axis folded back into time: audio
    [C, T/32, 2], rds_pred/valid [C, T/64].

    This is the offline/throughput path (the jitted equivalent of the
    fm_demod_benchmark fread loop) — one trace, no host round-trips.
    Pass ``coeffs`` to reuse an existing design (e.g. after
    ``update_controls``); by default they are designed from ``cfg``.
    """
    if coeffs is None:
        coeffs = make_coeffs(cfg)
    i8 = x.ndim == 3
    if i8:
        assert x.dtype == np.int8, "3-D input must be [2, C, T] int8 planes"
        _, c, t = x.shape
    else:
        c, t = x.shape
    assert t % block_size == 0
    n_blocks = t // block_size
    if state is None:
        state = demod_init_state(cfg, c)
    from fm_radio.utils.transfer import device_put_complex

    if i8:
        xd = jnp.asarray(x)
        xb = xd.reshape(2, c, n_blocks, block_size).transpose(2, 0, 1, 3)
    elif not np.iscomplexobj(x):
        xd = (
            jnp.asarray(np.asarray(x, np.float32))
            if isinstance(x, np.ndarray)
            else jnp.asarray(x)
        )
        xb = xd.reshape(c, n_blocks, block_size).transpose(1, 0, 2)
    else:
        if isinstance(x, np.ndarray):
            xd = device_put_complex(np.asarray(x))
        else:
            xd = jnp.asarray(x)
        xb = xd.reshape(c, n_blocks, block_size).transpose(1, 0, 2)

    def step(st, blk):
        st, outs = demod_block(cfg, coeffs, st, blk)
        # return only what demod_stream consumes — anything else (complex
        # rds_sym, per-sample bpsk iq) would be stacked across ALL blocks
        # by lax.scan: wasted device memory on the throughput path
        return st, {k: outs[k] for k in ("audio", "rds_pred", "rds_valid")}

    final_state, outs = jax.lax.scan(step, state, xb)
    # [n_blocks, C, ...] -> [C, n_blocks*...]
    audio = outs["audio"].transpose(1, 0, 2, 3).reshape(c, -1, 2)
    rds_pred = outs["rds_pred"].transpose(1, 0, 2).reshape(c, -1)
    rds_valid = outs["rds_valid"].transpose(1, 0, 2).reshape(c, -1)
    return final_state, {
        "audio": audio,
        "rds_pred": rds_pred,
        "rds_valid": rds_valid,
    }
