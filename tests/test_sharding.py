"""Multi-device tests on the virtual 8-device CPU mesh: channel sharding,
time-parallel halo demod A/B'd against the sequential stream, channelizer."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fm_radio.config import DemodConfig
from fm_radio.io.synth import FMModulator, ModulatorConfig
from fm_radio.models.app import demod_stream
from fm_radio.models.demod import demod_init_state, make_coeffs
from fm_radio.parallel import (
    channelize,
    channelizer_init_state,
    demod_time_parallel,
    make_channelizer_taps,
    make_mesh,
)
from fm_radio.parallel.sharding import demod_channels_sharded

BLOCK = 16384


@pytest.fixture(scope="module")
def iq():
    mod = FMModulator(ModulatorConfig())
    return mod.generate(BLOCK * 16, left_hz=1000.0, right_hz=3000.0)


def test_eight_devices_available():
    assert jax.device_count() == 8


def test_channel_sharded_matches_single(iq):
    cfg = DemodConfig()
    coeffs = make_coeffs(cfg)
    x = np.stack([iq[: BLOCK * 2]] * 8)  # 8 identical channels
    mesh = make_mesh(8, 1)
    state = demod_init_state(cfg, 8)
    st_sharded, outs_sharded = demod_channels_sharded(
        cfg, coeffs, state, jnp.asarray(x), mesh
    )
    st_local, outs_local = None, None
    from fm_radio.models.demod import demod_block

    st_local, outs_local = demod_block(cfg, coeffs, demod_init_state(cfg, 8), jnp.asarray(x))
    np.testing.assert_allclose(
        np.asarray(outs_sharded["audio"]), np.asarray(outs_local["audio"]), atol=1e-5
    )


@pytest.mark.slow
def test_time_parallel_i8_planes_matches_packed(iq):
    """[2, C, T] int8-plane ingest through the time-sharded path (halo
    ppermute on int8 — HALF the bytes between devices) is BIT-identical to
    the packed f32-word form: both decode to the same exact samples."""
    from fm_radio.io.pcm import c64_to_u8
    from fm_radio.utils.transfer import pack_iq_u8, split_iq_i8

    cfg = DemodConfig()
    coeffs = make_coeffs(cfg)
    u8 = c64_to_u8(np.asarray(iq)[: BLOCK * 8]).reshape(-1, 2)
    w = pack_iq_u8(u8)[None, :]           # [1, T] packed words
    i8 = split_iq_i8(u8)[:, None, :]      # [2, 1, T] int8 planes
    mesh = make_mesh(1, 4)

    outs_pk = demod_time_parallel(
        cfg, coeffs, jnp.asarray(w), mesh, block_size=BLOCK, warmup_blocks=1
    )
    outs_i8 = demod_time_parallel(
        cfg, coeffs, jnp.asarray(i8), mesh, block_size=BLOCK, warmup_blocks=1
    )
    for k in ("audio", "rds_pred", "rds_valid"):
        np.testing.assert_array_equal(
            np.asarray(outs_pk[k]), np.asarray(outs_i8[k]), err_msg=k
        )


@pytest.mark.slow
def test_time_parallel_matches_sequential(iq):
    """Halo warm-up reproduces the sequential stream away from cold-start:
    compare the payload of shard 1.. against the exact sequential output."""
    cfg = DemodConfig()
    coeffs = make_coeffs(cfg)
    x = np.asarray(iq)[None, :]  # [1, T], T = 16 blocks
    mesh = make_mesh(1, 4)

    outs_par = demod_time_parallel(
        cfg, coeffs, jnp.asarray(x), mesh, block_size=BLOCK, warmup_blocks=2
    )
    _, outs_seq = demod_stream(cfg, x, block_size=BLOCK)

    audio_par = np.asarray(outs_par["audio"])[0]
    audio_seq = np.asarray(outs_seq["audio"])[0]
    assert audio_par.shape == audio_seq.shape

    fs_audio = cfg.rates.fs_audio
    blk_audio = BLOCK // 32
    # Shard 0 carries the genuine stream start: its payload state is reset
    # to the true init at the warm-up boundary, so its audio must equal the
    # sequential stream EXACTLY (same program, same state, same blocks).
    np.testing.assert_array_equal(audio_par[: 4 * blk_audio],
                                  audio_seq[: 4 * blk_audio])
    # Each later shard covers 4 blocks of payload from a halo warm-up; skip
    # the first payload block right after warm-up and compare the settled
    # region.
    for shard in range(1, 4):
        lo = (shard * 4 + 1) * blk_audio
        hi = (shard + 1) * 4 * blk_audio
        seg_par = audio_par[lo:hi]
        seg_seq = audio_seq[lo:hi]
        err = np.sqrt(np.mean((seg_par - seg_seq) ** 2))
        ref = np.sqrt(np.mean(seg_seq**2)) + 1e-12
        snr = 20 * np.log10(ref / (err + 1e-12))
        assert snr > 25.0, f"shard {shard}: boundary SNR {snr:.1f} dB"


def test_time_parallel_2d_mesh(iq):
    """ch x t mesh compiles and runs with both axes sharded."""
    cfg = DemodConfig()
    coeffs = make_coeffs(cfg)
    x = np.stack([iq[: BLOCK * 8]] * 2)  # [2, 8 blocks]
    mesh = make_mesh(2, 4)
    outs = demod_time_parallel(
        cfg, coeffs, jnp.asarray(x), mesh, block_size=BLOCK, warmup_blocks=1
    )
    audio = np.asarray(outs["audio"])
    assert audio.shape == (2, BLOCK * 8 // 32, 2)
    np.testing.assert_allclose(audio[0], audio[1], atol=1e-4)


@pytest.mark.slow
def test_time_parallel_rds_groups_match_sequential():
    """RDS-level acceptance of the time-sharded path: groups decoded from
    the ``demod_time_parallel`` symbol stream must be word-identical to the
    sequential stream's — the multi-device story held to the same bar as
    the reference's bit-exact group decode (rds_group_sync.cpp:29-252).

    Warm-up must cover BPSK TED/PLL re-acquisition (~0.2 s), so each time
    shard gets a 16-block (0.25 s) raw-IQ halo; a corrupted group at the
    payload seam is tolerated (the chain's 3-group resync handles it, as it
    would a real burst error) but every decoded group must be genuine, and
    the parallel stream must recover the PI code and most of the traffic."""
    from fm_radio.rds.chain import RDSFullChain

    cfg = DemodConfig()
    coeffs = make_coeffs(cfg)
    mod = FMModulator(ModulatorConfig())
    groups_tx = [
        (0xC0DE, (0 << 12) | (1 << 10) | seg, 0xE101, word)
        for seg, word in enumerate((0x4142, 0x4344, 0x4546, 0x4748))
    ]
    n = BLOCK * 64  # 1.024 s: ~11 groups at 1187.5 bps
    iq = mod.generate(n, left_hz=1000.0, right_hz=3000.0,
                      rds_groups=groups_tx)[None, :]

    mesh = make_mesh(1, 2)
    outs_par = demod_time_parallel(
        cfg, coeffs, jnp.asarray(iq), mesh, block_size=BLOCK, warmup_blocks=16
    )
    _, outs_seq = demod_stream(cfg, iq, block_size=BLOCK)

    def decode(outs):
        chain = RDSFullChain()
        pred = np.asarray(outs["rds_pred"])[0]
        valid = np.asarray(outs["rds_valid"])[0]
        chain.process_symbols(pred[valid])
        return chain

    seq = decode(outs_seq)
    par = decode(outs_par)

    def words(chain):
        return [
            tuple(b.data for b in g)
            for g in chain.chain.groups
            if all(b.is_valid for b in g)
        ]

    seq_words, par_words = words(seq), words(par)
    assert len(seq_words) >= 8, f"sequential oracle too weak: {len(seq_words)}"
    # every fully-valid parallel group is genuine transmitted content
    tx_words = {(pi, b, c, d) for (pi, b, c, d) in groups_tx}
    assert set(par_words) <= tx_words, set(par_words) - tx_words
    assert set(par_words) == set(seq_words)
    # shard 0's payload is EXACTLY the sequential stream (state reset at its
    # payload boundary — its zero-halo warm-up must not pollute loop state),
    # and the one seam costs at most 2 groups of traffic (measured 0 across
    # six tone/phase variants after the shard-0 fix; pre-fix the zero-halo
    # pollution cost up to EVERYTHING shard 0 decoded)
    t_half = np.asarray(outs_par["rds_pred"]).shape[1] // 2
    np.testing.assert_array_equal(
        np.asarray(outs_par["rds_pred"])[0][:t_half],
        np.asarray(outs_seq["rds_pred"])[0][:t_half])
    assert len(par_words) >= len(seq_words) - 2, (len(par_words), len(seq_words))
    assert par.db.pi_code == seq.db.pi_code == 0xC0DE

    # fast_resync was measured here and does NOT help at shard seams:
    # bit-framing usually SURVIVES the seam (the warm-up re-locks the symbol
    # clock), so an immediate resync forfeits a correctly-framed group that
    # the reference's 3-group patience keeps.  It remains an opt-in for true
    # framing-loss bursts (tests/test_rds.py), not a seam optimization —
    # recorded so future rounds don't re-try.


def test_rds_warmup_blocks_sizing():
    from fm_radio.parallel import rds_warmup_blocks

    assert rds_warmup_blocks(16384) == 16      # 0.25 s at 1.024 MHz
    assert rds_warmup_blocks(65536) == 4
    assert rds_warmup_blocks(65536, DemodConfig()) == 4
    assert rds_warmup_blocks(1 << 22) == 1     # never zero


@pytest.mark.slow
def test_superblock_stream_matches_sequential():
    """Super-block streaming: a 96-block capture in three time-sharded
    super-blocks, each seeded with the previous chunk's real-IQ tail as
    shard 0's halo.  The concatenated stream must carry the sequential
    stream's RDS traffic (boundaries are ordinary warm-up seams, not cold
    starts) and settled audio must match.
    """
    from fm_radio.parallel import demod_superblock_stream
    from fm_radio.rds.chain import RDSFullChain

    cfg = DemodConfig()
    coeffs = make_coeffs(cfg)
    mod = FMModulator(ModulatorConfig())
    groups_tx = [
        (0xFEED, (0 << 12) | (1 << 10) | seg, 0xE101, word)
        for seg, word in enumerate((0x4142, 0x4344, 0x4546, 0x4748))
    ]
    n_blocks = 96
    x = mod.generate(BLOCK * n_blocks, left_hz=1000.0, right_hz=3000.0,
                     rds_groups=groups_tx)[None, :]
    mesh = make_mesh(1, 2)
    warm = 16

    chunks = list(demod_superblock_stream(
        cfg, coeffs, x, mesh, block_size=BLOCK, warmup_blocks=warm,
        superblock_blocks=16,
    ))
    assert len(chunks) == 3
    audio = np.concatenate([c["audio"] for c in chunks], axis=1)
    pred = np.concatenate([c["rds_pred"] for c in chunks], axis=1)
    valid = np.concatenate([c["rds_valid"] for c in chunks], axis=1)

    _, outs_seq = demod_stream(cfg, x, block_size=BLOCK)
    audio_seq = np.asarray(outs_seq["audio"])

    assert audio.shape == audio_seq.shape
    # first super-block starts the stream: shard 0 of it is exact
    blk_audio = BLOCK // 32
    np.testing.assert_array_equal(audio[0, : 16 * blk_audio],
                                  audio_seq[0, : 16 * blk_audio])
    # settled audio across all later super-blocks
    err = audio[0, 17 * blk_audio:] - audio_seq[0, 17 * blk_audio:]
    ref = np.sqrt(np.mean(audio_seq[0, 17 * blk_audio:] ** 2)) + 1e-12
    snr = 20 * np.log10(ref / (np.sqrt(np.mean(err**2)) + 1e-12))
    assert snr > 25.0, snr

    def ngroups(p, v):
        ch = RDSFullChain()
        ch.process_symbols(p[v])
        return [tuple(b.data for b in g) for g in ch.chain.groups
                if all(b.is_valid for b in g)]

    seq_words = ngroups(np.asarray(outs_seq["rds_pred"])[0],
                        np.asarray(outs_seq["rds_valid"])[0])
    got_words = ngroups(pred[0], valid[0])
    assert len(seq_words) >= 12, len(seq_words)
    tx = set(groups_tx)
    assert set(got_words) <= tx
    # 5 seams (2 internal + 2 super-block boundaries + ...), each worth at
    # most ~2 groups of traffic against the sequential stream
    assert len(got_words) >= len(seq_words) - 8, (
        len(got_words), len(seq_words))


# ------------------------------------------------------------- channelizer


def test_channelizer_extracts_tones():
    """Wideband with tones in channels 1 and 5 -> energy lands in the right
    channel outputs, matching direct mix+decimate within filter accuracy."""
    m, k = 8, 16
    fs = 8.0  # normalized
    n = 4096 * m
    t = np.arange(n)
    # tone at channel 1 center + small offset, another at channel 5 (=-3)
    f1 = (1.0 + 0.05) / m
    f5 = (5.0 - 0.1) / m - 1.0  # wraps negative
    x = (
        np.exp(2j * np.pi * f1 * t) + 0.5 * np.exp(2j * np.pi * f5 * t)
    ).astype(np.complex64)

    taps = make_channelizer_taps(m, k)
    st = channelizer_init_state(m, k)
    _, y = channelize(taps, st, jnp.asarray(x), m)
    y = np.asarray(y)
    assert y.shape == (m, n // m + k - 1 - (k - 1))

    power = np.mean(np.abs(y[:, 64:]) ** 2, axis=1)
    assert np.argmax(power) == 1
    others = np.delete(power, [1, 5])
    assert power[1] > 50 * others.max()
    assert power[5] > 50 * others.max()


def test_channelizer_matches_direct_downconversion():
    m, k = 4, 16
    n = 1024 * m
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    taps = make_channelizer_taps(m, k)
    st = channelizer_init_state(m, k)
    _, y = channelize(taps, st, jnp.asarray(x), m)
    y = np.asarray(y)

    import scipy.signal as sig

    x_pad = np.concatenate([np.zeros((k - 1) * m, np.complex64), x])
    for ch in range(m):
        mixed = x_pad * np.exp(-2j * np.pi * ch * np.arange(len(x_pad)) / m)
        filt = sig.lfilter(taps, [1.0], mixed)
        ref = filt[(k - 1) * m + m - 1 :: m]
        # channelizer windows end at n*m + NN-1 in padded coords =>
        # ref sample n at padded index n*m + NN - 1
        ref = filt[m * np.arange(y.shape[1]) + m * k - 1]
        # account for the twiddle using padded-coords (offset (k-1)*m = 0 mod m)
        np.testing.assert_allclose(y[ch], ref, atol=2e-4)


def test_channelizer_streaming():
    m, k = 4, 8
    n = 512 * m
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    taps = make_channelizer_taps(m, k)
    st = channelizer_init_state(m, k)
    _, y_full = channelize(taps, st, jnp.asarray(x), m)
    st = channelizer_init_state(m, k)
    parts = []
    for blk in np.split(x, 4):
        st, y = channelize(taps, st, jnp.asarray(blk), m)
        parts.append(np.asarray(y))
    np.testing.assert_allclose(
        np.asarray(y_full), np.concatenate(parts, axis=1), atol=1e-5
    )


@pytest.mark.slow
def test_pod_scale_channel_count():
    """Config-5 shape scaled for CI: 1024 channels sharded over 8 devices
    (across hosts the mesh spans processes; the program is identical —
    only the Mesh construction changes)."""
    cfg = DemodConfig()
    coeffs = make_coeffs(cfg)
    c, block = 1024, 4096
    rng = np.random.default_rng(0)
    ph = np.cumsum(rng.standard_normal((c, block)) * 0.5, -1)
    x = (100 * np.exp(1j * ph)).astype(np.complex64)
    mesh = make_mesh(8, 1)
    state = demod_init_state(cfg, c)
    _, outs = demod_channels_sharded(cfg, coeffs, state, jnp.asarray(x), mesh)
    audio = np.asarray(outs["audio"])
    assert audio.shape == (c, block // 32, 2)
    assert np.isfinite(audio).all()


@pytest.mark.slow
def test_wideband_stations_to_audio_and_rds():
    """Config-4 pipeline in miniature: synthesize TWO complete FM stations
    (different audio tones + different RDS PI codes) at different carriers in
    one wideband capture, channelize, then run the channel-batched demod on
    the extracted stations — each must recover its own tone and PI code."""
    from fm_radio.io.synth import FMModulator, ModulatorConfig
    from fm_radio.models.app import App
    from fm_radio.parallel.channelizer import (
        channelize,
        channelizer_init_state,
        make_channelizer_taps,
    )

    m = 8                      # 8 channels of 1.024 MHz each
    fs_ch = 1_024_000
    n_ch_samples = 32768 * 32  # ~1 s per channel: TED/PLL lock (~0.2 s),
    # a possible false block-A lock costs 3 groups (~0.27 s), then >3 real groups
    n_wide = n_ch_samples * m

    stations = {1: (0x1111, 1000.0), 5: (0x2222, 2500.0)}
    wide = np.zeros(n_wide, np.complex64)
    t = np.arange(n_wide) / (fs_ch * m)
    for k, (pi, tone) in stations.items():
        mod = FMModulator(ModulatorConfig())
        groups = [(pi, (0 << 12) | (1 << 10), 0xE101, 0x4142)]
        iq = mod.generate(n_ch_samples, left_hz=tone, right_hz=tone,
                          rds_groups=groups)
        # station k sits at carrier k * fs_ch; upsample by zero-order hold is
        # NOT needed: build at channel rate then mix up at wide rate
        up = np.repeat(iq, m)[:n_wide]  # crude ZOH interpolation to wide rate
        wide += (up * np.exp(2j * np.pi * (k * fs_ch) * t)).astype(np.complex64)

    taps = make_channelizer_taps(m)
    st = channelizer_init_state(m, 16)
    _, ch = channelize(taps, st, jnp.asarray(wide), m)
    ch = np.asarray(ch)  # [M, n_ch_samples]

    # demod the two station channels as one batch
    ks = sorted(stations)
    x = np.stack([ch[k] for k in ks]) / m  # undo FFT scaling
    app = App(block_size=32768, channels=2)
    app.process(x.astype(np.complex64))

    fs_audio = app.demod.fs_audio
    settle = int(0.1 * fs_audio)
    for i, k in enumerate(ks):
        pi, tone = stations[k]
        audio = app.audio[i][settle:, 0]
        spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
        freqs = np.fft.rfftfreq(len(audio), 1 / fs_audio)
        peak = freqs[np.argmax(spec)]
        assert abs(peak - tone) < 40.0, f"station {k}: peak {peak} != {tone}"
        db = app.rds_database(i)
        assert db.pi_code == pi, f"station {k}: PI {db.pi_code:04X} != {pi:04X}"


def test_channelizer_packed_matches_planes():
    """Packed u8-word wideband ingest == the centered plane path (the
    unpack is exact integer arithmetic)."""
    from fm_radio.parallel.channelizer import channelize_p
    from fm_radio.utils.transfer import pack_iq_u8

    m, k = 8, 8
    t = m * 1024
    rng = np.random.default_rng(3)
    iq_u8 = rng.integers(0, 256, (t, 2)).astype(np.uint8)
    xr = iq_u8[:, 0].astype(np.float32) - 127.0
    xi = iq_u8[:, 1].astype(np.float32) - 127.0
    w = jnp.asarray(pack_iq_u8(iq_u8))
    taps = make_channelizer_taps(m, k)
    st = (jnp.zeros((k - 1) * m, jnp.float32),) * 2

    st1, (ar, ai) = channelize_p(taps, st, (jnp.asarray(xr), jnp.asarray(xi)), m)
    st2, (br, bi) = channelize_p(taps, st, w, m)
    np.testing.assert_array_equal(np.asarray(ar), np.asarray(br))
    np.testing.assert_array_equal(np.asarray(ai), np.asarray(bi))
    for a, b in zip(st1, st2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_channelizer_streaming_single_tap_phase():
    """taps_per_phase==1: carried state must be empty (a `-(k-1)*m:` slice
    once carried the whole padded block and duplicated channel samples)."""
    m = 4
    n = 64 * m
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    taps = np.full(m, 1.0, np.float32)  # K=1: plain M-point DFT bank
    st = channelizer_init_state(m, 1)
    _, y_full = channelize(taps, st, jnp.asarray(x), m)
    st = channelizer_init_state(m, 1)
    parts = []
    for blk in np.split(x, 2):
        st, y = channelize(taps, st, jnp.asarray(blk), m)
        parts.append(np.asarray(y))
    got = np.concatenate(parts, axis=1)
    assert got.shape == np.asarray(y_full).shape
    np.testing.assert_allclose(np.asarray(y_full), got, atol=1e-5)


def test_time_parallel_zero_warmup_shapes(iq):
    """warmup_blocks=0 must emit exactly the payload length (a `-0:` halo
    slice once prepended the ENTIRE left shard, doubling the output)."""
    cfg = DemodConfig()
    coeffs = make_coeffs(cfg)
    x = np.asarray(iq)[None, :]
    mesh = make_mesh(1, 4)
    outs = demod_time_parallel(
        cfg, coeffs, jnp.asarray(x), mesh, block_size=BLOCK, warmup_blocks=0
    )
    audio = np.asarray(outs["audio"])
    assert audio.shape == (1, x.shape[-1] // 32, 2)
    assert np.isfinite(audio).all()
