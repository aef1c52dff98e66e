"""Mesh sharding for multi-device / multi-host demodulation.

Two orthogonal axes (scaling-book style: pick a mesh, annotate shardings, let
XLA insert collectives):

* ``ch`` — independent FM channels.  Pure data parallelism: every op in the
  pipeline (including the lax.scan loop carries) is elementwise across C, so
  sharding the leading axis partitions the whole computation with ZERO
  communication.  This is the throughput axis: aggregate MHz per device
  scales with channels per device.

* ``t`` — time-block sequence parallelism for one long stream.  The
  reference carries all cross-block continuity in O(filter_order) state
  (SURVEY.md §5.7), which is exactly an overlap-save decomposition: each time
  shard needs (a) a halo of raw IQ from its left neighbor (exchanged with
  ``lax.ppermute``) to warm up filters and re-acquire the PLL/TED
  loops, after which its outputs match the sequential stream; (b) nothing
  else.  Warm-up length is a config knob (loop bandwidths are ~100 Hz, so
  ~0.2 s of signal re-acquires lock; FIR tails need only (K-1)*M samples).

Exact-state handoff (bit-identical to sequential) is available as
``demod_stream`` scanned over shards — sequential in time but still batched
over channels; the halo variant trades boundary transients for full
parallelism.  Both are tested A/B (tests/test_sharding.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fm_radio.config import DemodConfig
from fm_radio.models.demod import DemodCoeffs, demod_block, demod_init_state, make_coeffs


def rds_warmup_blocks(block_size: int, cfg: DemodConfig | None = None,
                      seconds: float = 0.25) -> int:
    """Halo length (in blocks) for RDS-grade time sharding: enough signal
    for the BPSK TED/PLL to re-acquire from cold (~0.2 s at the reference
    loop gains, bpsk_synchroniser.h:18-32) plus margin.  Measured knee
    (docs/SCALING.md): 128 ms halo loses the shard's RDS traffic, 192 ms
    recovers sequential group counts exactly; the 0.25 s default sits above
    it with margin.  Audio-only consumers can use 1-2 blocks (the pilot PLL
    settles in ~20 ms)."""
    fs = cfg.rates.fs_baseband if cfg is not None else 1_024_000
    return max(1, -(-int(seconds * fs) // block_size))


def make_mesh(n_ch: int, n_t: int = 1, devices=None) -> Mesh:
    """2D device mesh [ch, t], laid out flat over ``devices``."""
    if devices is None:
        devices = jax.devices()
    assert len(devices) >= n_ch * n_t, "not enough devices"
    dev = np.asarray(devices[: n_ch * n_t]).reshape(n_ch, n_t)
    return Mesh(dev, ("ch", "t"))


# ---------------------------------------------------------------------------
# Channel sharding (DP)
# ---------------------------------------------------------------------------


def demod_channels_sharded(
    cfg: DemodConfig,
    coeffs: DemodCoeffs,
    state: dict,
    x: jnp.ndarray,
    mesh: Mesh,
):
    """One demod block with channels sharded over the full mesh.

    x: [C, B] (complex64 / packed f32 words) or [2, C, B] int8 planes; C must
    be divisible by the mesh size.  State arrays keep their leading [C] (or
    [2C]) axis sharded the same way, so the scan carries stay local to each
    device — no collectives at all in the steady state.
    """
    flat = P(("ch", "t"))
    x_sharding = NamedSharding(
        mesh,
        P(None, ("ch", "t"), None) if x.ndim == 3 else P(("ch", "t"), None),
    )

    def shard_state(s):
        # state leaves have leading channel-like axis (C or 2C)
        return jax.tree.map(
            lambda a: jax.device_put(
                a, NamedSharding(mesh, P(flat[0], *([None] * (a.ndim - 1))))
            ),
            s,
        )

    x = jax.device_put(x, x_sharding)
    state = shard_state(state)
    return demod_block(cfg, coeffs, state, x)


# ---------------------------------------------------------------------------
# Time-block sequence parallelism (SP) via shard_map + ppermute halo
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("cfg", "block_size", "warmup_blocks", "mesh_axis", "mesh")
)
def demod_time_parallel(
    cfg: DemodConfig,
    coeffs: DemodCoeffs,
    x: jnp.ndarray,
    mesh: Mesh,
    block_size: int = 65536,
    warmup_blocks: int = 2,
    mesh_axis: str = "t",
    left_halo: jnp.ndarray | None = None,
):
    """Demodulate one long stream with the time axis sharded over ``mesh_axis``
    (channels sharded over the other axis if present).

    x: [C, T] (complex64 or packed f32 words) — or [2, C, T] int8 planes
    (utils/transfer.split_iq_i8, the default ingest: the raw-IQ halo
    exchanged between devices is HALF the packed form's bytes).
    T divisible by (n_t * block_size).  Each shard receives a
    ``warmup_blocks * block_size`` halo of raw IQ from its left neighbor
    (ppermute), demodulates warm-up + payload from a cold state, and
    discards the warm-up outputs.  Shard 0's halo is zeros — it is genuinely
    the stream start, and its carried state resets to the true init at the
    payload boundary so its payload equals the sequential stream exactly.

    Choosing ``warmup_blocks``: the audio path (pilot PLL, ~100 Hz loop
    bandwidth) settles within ~2 blocks at 65536; the RDS path needs the
    BPSK TED/PLL to re-acquire — budget >=0.25 s of halo (16 blocks at
    16384, 4 at 65536) when downstream consumers decode RDS.

    ``left_halo`` ([C, warmup_blocks*block_size] raw IQ, the samples
    immediately PRECEDING x in the stream) makes shard 0 a mid-stream shard:
    it warms up on real signal like every other shard instead of starting
    cold — the super-block streaming mode (``demod_superblock_stream``).

    Returns outs dict with audio [C, T/32, 2], rds_pred/valid [C, T/64]
    (sharded along the time axis).
    """
    n_t = mesh.shape[mesh_axis]
    other_axes = tuple(a for a in mesh.axis_names if a != mesh_axis)
    i8 = x.ndim == 3  # [2, C, T] int8 planes
    c, t = x.shape[1:] if i8 else x.shape
    assert t % (n_t * block_size) == 0
    halo = warmup_blocks * block_size

    ch_spec = (*other_axes,) if other_axes else (None,)
    in_spec = P(None, *ch_spec, mesh_axis) if i8 else P(*ch_spec, mesh_axis)
    halo_spec = P(None, *ch_spec, None) if i8 else P(*ch_spec, None)
    stream_start = left_halo is None
    if stream_start:
        # dummy (zeros) so shard_fn's signature is static either way
        shape = (2, c, halo) if i8 else (c, halo)
        left_halo = jnp.zeros(shape, x.dtype)

    def shard_fn(x_local: jnp.ndarray, halo0: jnp.ndarray):
        # x_local: [C_local, T/n_t] (or [2, C_local, T/n_t] int8 planes);
        # halo0: matching [.., halo] (time-replicated)
        c_local = x_local.shape[-2]
        # halo: my last `halo` samples -> right neighbor (positive slice
        # start: `-halo:` with warmup_blocks==0 would send the whole shard)
        my_tail = x_local[..., x_local.shape[-1] - halo:]
        left_tail = jax.lax.ppermute(
            my_tail, mesh_axis, [(i, (i + 1) % n_t) for i in range(n_t)]
        )
        my_idx = jax.lax.axis_index(mesh_axis)
        # shard 0's halo: zeros at the genuine stream start, or the caller-
        # provided preceding samples in super-block streaming mode
        shard0_halo = jnp.zeros_like(left_tail) if stream_start else halo0
        left_tail = jnp.where(my_idx == 0, shard0_halo, left_tail)
        x_ext = jnp.concatenate([left_tail, x_local], axis=-1)

        n_blocks = x_ext.shape[-1] // block_size
        state = demod_init_state(cfg, c_local)
        if i8:
            xb = x_ext.reshape(2, c_local, n_blocks, block_size).transpose(
                2, 0, 1, 3)
        else:
            xb = x_ext.reshape(c_local, n_blocks, block_size).transpose(1, 0, 2)

        def step(st, blk_i):
            blk, i = blk_i
            st, outs = demod_block(cfg, coeffs, st, blk)
            # shard 0 at the genuine stream start: its "halo" is zeros,
            # and demodulating zero-blocks POLLUTES the loop state (AGC
            # winds up on silence, PLL/TED drift) — measurably worse than a
            # cold start (it could kill shard 0's RDS entirely).  Entering
            # the payload, discard that state and start from the true init:
            # shard 0's payload then equals the sequential stream EXACTLY.
            # (In streaming mode shard 0 warms up on REAL preceding samples
            # like every other shard — no reset.)
            reset = jnp.logical_and(my_idx == 0,
                                    i == max(warmup_blocks - 1, 0))
            if warmup_blocks > 0 and stream_start:
                st = jax.tree_util.tree_map(
                    lambda new, init: jnp.where(reset, init, new),
                    st, demod_init_state(cfg, c_local))
            return st, outs

        _, outs = jax.lax.scan(step, state, (xb, jnp.arange(n_blocks)))
        # drop warm-up blocks, fold block axis into time
        audio = outs["audio"][warmup_blocks:].transpose(1, 0, 2, 3).reshape(c_local, -1, 2)
        rds_pred = outs["rds_pred"][warmup_blocks:].transpose(1, 0, 2).reshape(c_local, -1)
        rds_valid = outs["rds_valid"][warmup_blocks:].transpose(1, 0, 2).reshape(c_local, -1)
        return audio, rds_pred, rds_valid

    audio, rds_pred, rds_valid = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(in_spec, halo_spec),
        out_specs=(
            P(*ch_spec, mesh_axis, None),
            P(*ch_spec, mesh_axis),
            P(*ch_spec, mesh_axis),
        ),
        check_vma=False,
    )(x, left_halo)
    return {"audio": audio, "rds_pred": rds_pred, "rds_valid": rds_valid}


def demod_superblock_stream(
    cfg: DemodConfig,
    coeffs: DemodCoeffs,
    x,
    mesh: Mesh,
    block_size: int = 65536,
    warmup_blocks: int = 2,
    superblock_blocks: int | None = None,
    mesh_axis: str = "t",
):
    """Time-parallel demodulation of an arbitrarily long recorded capture in
    SUPER-BLOCK chunks: each chunk of ``n_t * superblock_blocks`` blocks is
    demodulated with the time axis sharded over the mesh, and the next chunk
    receives the previous chunk's final ``warmup_blocks`` of raw IQ as shard
    0's halo (``left_halo``) — every super-block boundary is an ordinary
    warm-up seam on REAL samples, not a cold start.  Host memory is
    O(super-block); device memory is O(shard).

    x: [C, T] array-like supporting contiguous slicing (numpy, or a
    channelwise lazy view).  T must divide into super-blocks.  Yields
    host-side outs dicts per super-block (audio [C, S/32, 2],
    rds_pred/valid [C, S/64]).
    """
    n_t = mesh.shape[mesh_axis]
    if superblock_blocks is None:
        superblock_blocks = 8 * warmup_blocks  # ~11% warm-up overhead
    span = n_t * superblock_blocks * block_size
    t = x.shape[-1]
    assert t % span == 0, (t, span)
    halo = warmup_blocks * block_size

    left = None
    for i0 in range(0, t, span):
        xs = jnp.asarray(np.asarray(x[..., i0 : i0 + span]))
        outs = demod_time_parallel(
            cfg, coeffs, xs, mesh, block_size=block_size,
            warmup_blocks=warmup_blocks, mesh_axis=mesh_axis,
            left_halo=left,
        )
        left = xs[..., span - halo:]
        yield {k: np.asarray(v) for k, v in outs.items()}


def demod_full_mesh(
    cfg: DemodConfig,
    x: np.ndarray,
    mesh: Mesh,
    block_size: int = 65536,
    warmup_blocks: int = 1,
):
    """Convenience: channels over 'ch', time over 't', everything jitted."""
    coeffs = make_coeffs(cfg)
    return demod_time_parallel(
        cfg, coeffs, jnp.asarray(x), mesh, block_size, warmup_blocks, "t"
    )
