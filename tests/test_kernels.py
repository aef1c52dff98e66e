"""Pallas (Triton) loop-kernel parity tests — interpret mode on CPU —
against the lax.scan reference implementations, plus the wrapper's tile
choice and padding and demod_block's choice of loop path."""

from dataclasses import replace

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fm_radio.config import DemodConfig
from fm_radio.kernels.bpsk_pallas import bpsk_sync_pallas
from fm_radio.kernels.pll_pallas import (
    MAX_TILE,
    check_time_chunks,
    pad_channels,
    pick_channel_tile,
    pilot_pll_pallas,
)
from fm_radio.models.bpsk import bpsk_init_state, bpsk_sync_scan
from fm_radio.models.demod import (
    demod_block,
    demod_init_state,
    loop_kernels_enabled,
    make_coeffs,
)
from fm_radio.models.pilot_pll import pilot_pll_init_state, pilot_pll_scan
from fm_radio.utils.transfer import init_on_device

RNG = np.random.default_rng(5)
CFG = DemodConfig()


def _pilot_signal(c, n):
    """Noisy 19 kHz-ish pilot at Fs=128k so the loop actually locks."""
    fs = CFG.rates.fs_fm_out
    t = np.arange(n) / fs
    x = np.exp(1j * (2 * np.pi * 19015.0 * t + 0.7))
    x = x[None, :] + 0.01 * (
        RNG.standard_normal((c, n)) + 1j * RNG.standard_normal((c, n))
    )
    return x.astype(np.complex64)


def _rds_signal(c, n):
    """BPSK-ish signal at 16 kHz, 2 kHz symbols on the Q axis."""
    sps = 8
    syms = RNG.choice([-1.0, 1.0], size=(c, n // sps + 1))
    d = np.repeat(syms, sps, axis=1)[:, :n]
    x = (0.7j * d + 0.05 * (RNG.standard_normal((c, n)) + 1j * RNG.standard_normal((c, n))))
    return x.astype(np.complex64)


def _wrapped(a, b):
    d = np.asarray(a) - np.asarray(b)
    return np.abs(d - np.round(d))


# C = 1 (one live station), a full power-of-two tile, and a channel count
# that needs padding; n not a multiple of the kernel's unroll
@pytest.mark.parametrize("c", [1, 8, 13])
def test_pll_pallas_matches_scan(c):
    n = 517
    coeffs = make_coeffs(CFG)
    pilot = jnp.asarray(_pilot_signal(c, n))
    st0 = init_on_device(pilot_pll_init_state, c)

    st_scan, taps = pilot_pll_scan(coeffs.pll, st0, pilot)
    st_pal, dt = pilot_pll_pallas(CFG, st0, pilot, interpret=True)

    assert dt.shape == (c, n)
    # the kernel wraps by t - floor(t + 1/2), the scan by t - round(t): a
    # tie can land on +-0.5 of the same phase, so compare modulo one cycle
    assert _wrapped(dt, taps["dt"]).max() < 2e-6
    for a, b in zip(st_scan, st_pal):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("c", [2, 13])
def test_pll_pallas_streaming(c):
    """A block split in two continues exactly from the carried state."""
    n = 512
    pilot = jnp.asarray(_pilot_signal(c, n))
    st = init_on_device(pilot_pll_init_state, c)
    st1, dt_full = pilot_pll_pallas(CFG, st, pilot, interpret=True)
    st2, dt_a = pilot_pll_pallas(CFG, st, pilot[:, : n // 2], interpret=True)
    st2, dt_b = pilot_pll_pallas(CFG, st2, pilot[:, n // 2 :], interpret=True)
    np.testing.assert_array_equal(
        np.asarray(dt_full), np.concatenate([dt_a, dt_b], axis=1))
    for a, b in zip(st1, st2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("c", [1, 8, 13])
def test_bpsk_pallas_matches_scan(c):
    n = 517
    coeffs = make_coeffs(CFG)
    x = jnp.asarray(_rds_signal(c, n))
    st0 = init_on_device(bpsk_init_state, c)

    st_scan, outs_scan = bpsk_sync_scan(coeffs.bpsk, st0, x)
    st_pal, outs_pal = bpsk_sync_pallas(CFG, st0, x, interpret=True)

    np.testing.assert_array_equal(
        np.asarray(outs_pal["valid"]), np.asarray(outs_scan["valid"])
    )
    # predicted symbols agree where valid
    v = np.asarray(outs_scan["valid"])
    assert v.any()
    np.testing.assert_allclose(
        np.asarray(outs_pal["pred"])[v], np.asarray(outs_scan["pred"])[v], atol=1e-5
    )
    # all carried state agrees
    for name in st_scan._fields:
        a = np.asarray(getattr(st_scan, name))
        b = np.asarray(getattr(st_pal, name))
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=name)


def test_bpsk_pallas_streaming():
    """A block split in two continues exactly from the carried state."""
    c, n = 3, 512
    x = jnp.asarray(_rds_signal(c, n))
    st = init_on_device(bpsk_init_state, c)
    st1, o_full = bpsk_sync_pallas(CFG, st, x, interpret=True)
    st2, o_a = bpsk_sync_pallas(CFG, st, x[:, : n // 2], interpret=True)
    st2, o_b = bpsk_sync_pallas(CFG, st2, x[:, n // 2 :], interpret=True)
    for k in ("pred", "valid"):
        np.testing.assert_array_equal(
            np.asarray(o_full[k]), np.concatenate([o_a[k], o_b[k]], axis=1))
    for a, b in zip(st1, st2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pll_chunked_matches_sequential():
    """Block-parallel PLL (pll_time_chunks>1): chunk 0 exact, later chunks
    within the documented ~3e-3-cycle band of the sequential trajectory."""
    c, n, g = 2, 32768, 4
    t = np.arange(n) / 128000.0
    ph = 2 * np.pi * 19000 * t
    x = (np.exp(1j * ph)[None, :] * np.ones((c, 1))).astype(np.complex64)
    pilot = jnp.asarray(x)

    cfg_par = replace(CFG, pll_time_chunks=g, pll_chunk_warmup=4096)
    st0 = init_on_device(pilot_pll_init_state, c)
    # several warm blocks so the entry state is fully locked (the loop's
    # proportional time constant is ~20k samples)
    st1 = st0
    for _ in range(4):
        st1, _ = pilot_pll_pallas(CFG, st1, pilot, interpret=True)
    _, dt_seq = pilot_pll_pallas(CFG, st1, pilot, interpret=True)
    _, dt_par = pilot_pll_pallas(cfg_par, st1, pilot, interpret=True)

    e = np.angle(
        np.exp(2j * np.pi * (np.asarray(dt_par) - np.asarray(dt_seq)))
    ) / (2 * np.pi)
    l = n // g
    np.testing.assert_array_equal(e[:, :l], 0.0)  # chunk 0 bit-exact
    assert np.abs(e).max() < 1e-2, np.abs(e).max()
    assert np.sqrt((e**2).mean()) < 4e-3


def test_pll_chunked_gcd_lane_count():
    """Chunked PLL whose C*G channels need padding to the tile (5*2 = 10 ->
    16): must run, with chunk 0 bit-exact vs the sequential kernel."""
    c, n, g = 5, 4096, 2
    t = np.arange(n) / 128000.0
    x = (np.exp(2j * np.pi * 19000 * t)[None, :] * np.ones((c, 1))).astype(
        np.complex64
    )
    pilot = jnp.asarray(x)
    cfg_par = replace(CFG, pll_time_chunks=g, pll_chunk_warmup=512)
    st0 = init_on_device(pilot_pll_init_state, c)
    _, dt_seq = pilot_pll_pallas(CFG, st0, pilot, interpret=True)
    _, dt_par = pilot_pll_pallas(cfg_par, st0, pilot, interpret=True)
    np.testing.assert_array_equal(
        np.asarray(dt_par)[:, : n // g], np.asarray(dt_seq)[:, : n // g]
    )


def test_pll_pallas_non_power_of_two_channel_tile():
    """c=2560 (80 tiles) and c=37 (padded to 64): every tile matches."""
    coeffs = make_coeffs(CFG)
    for c, n in ((2560, 48), (37, 64)):
        pilot = jnp.tile(jnp.asarray(_pilot_signal(4, n)), (-(-c // 4), 1))[:c]
        st0 = init_on_device(pilot_pll_init_state, c)
        _, taps = pilot_pll_scan(coeffs.pll, st0, pilot)
        _, dt = pilot_pll_pallas(CFG, st0, pilot, interpret=True)
        assert _wrapped(dt, taps["dt"]).max() < 2e-6, c


def test_bpsk_pallas_gcd_channel_tile():
    """c=768 (24 tiles of 32): output-identical to the scan."""
    c, n = 768, 256
    coeffs = make_coeffs(CFG)
    x = jnp.asarray(_rds_signal(c, n))
    st0 = init_on_device(bpsk_init_state, c)

    st_scan, outs_scan = bpsk_sync_scan(coeffs.bpsk, st0, x)
    st_pal, outs_pal = bpsk_sync_pallas(CFG, st0, x, interpret=True)
    np.testing.assert_array_equal(
        np.asarray(outs_pal["valid"]), np.asarray(outs_scan["valid"])
    )
    for name in st_scan._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(st_scan, name)),
            np.asarray(getattr(st_pal, name)), atol=1e-5, err_msg=name,
        )


@pytest.mark.parametrize("c, tile, padded", [
    (1, 1, 1), (5, 8, 8), (32, 32, 32), (33, 32, 64), (2048, 32, 2048),
    (3000, 32, 3008),
])
def test_pick_channel_tile(c, tile, padded):
    """Power-of-two tile up to MAX_TILE; channels padded to whole tiles."""
    assert MAX_TILE == 32
    assert pick_channel_tile(c) == (tile, padded)


def test_pad_channels():
    x = jnp.arange(12, dtype=jnp.float32).reshape(2, 6)
    assert pad_channels(x, 6) is x
    y = pad_channels(x, 8)
    assert y.shape == (2, 8)
    np.testing.assert_array_equal(np.asarray(y[:, :6]), np.asarray(x))
    np.testing.assert_array_equal(np.asarray(y[:, 6:]), 0.0)


@pytest.mark.parametrize("loop_impl, taps, want", [
    ("auto", False, False),   # CPU backend: the scan
    ("auto", True, False),
    ("scan", False, False),
    ("pallas", True, True),   # forced: the kernels even with taps asked for
])
def test_loop_kernels_enabled(loop_impl, taps, want):
    assert jax.default_backend() == "cpu"
    assert loop_kernels_enabled(DemodConfig(loop_impl=loop_impl), taps) is want


def test_time_chunks_refused_on_scan_path():
    """pll_time_chunks is implemented by the kernel path only: the scan
    path refuses it instead of silently running the sequential loop."""
    with pytest.raises(ValueError, match="pll_time_chunks"):
        loop_kernels_enabled(DemodConfig(loop_impl="scan", pll_time_chunks=2))


def test_time_chunks_refused_for_short_blocks():
    cfg = DemodConfig(pll_time_chunks=4, pll_chunk_warmup=4096)
    check_time_chunks(cfg, 32768)  # 8192-sample chunks: fine
    for n in (16384, 32770):       # chunks <= warm-up / not divisible
        with pytest.raises(ValueError, match="pll_time_chunks=4"):
            check_time_chunks(cfg, n)


def test_forced_kernels_need_a_gpu_or_the_interpreter():
    """loop_impl="pallas" on the CPU fails loudly
    (the Triton route has no CPU lowering) instead of quietly running the
    kernels through the interpreter."""
    cfg = DemodConfig(loop_impl="pallas")
    x = jnp.zeros((2, 1, 4096), jnp.float32)
    with pytest.raises(Exception, match="(?i)interpret mode"):
        demod_block(cfg, make_coeffs(cfg), demod_init_state(cfg, 1), x)


@pytest.mark.slow
def test_demod_block_pallas_path_matches_scan_path(monkeypatch):
    """Full pipeline with loop_impl=pallas (interpret) vs scan."""
    from functools import partial

    from fm_radio.io.synth import FMModulator, ModulatorConfig
    from fm_radio.models import demod

    for name in ("pilot_pll_pallas", "bpsk_sync_pallas"):
        monkeypatch.setattr(demod, name,
                            partial(getattr(demod, name), interpret=True))
    jax.clear_caches()  # no trace of the compiled-kernel path may be reused

    mod = FMModulator(ModulatorConfig())
    iq = mod.generate(8192, left_hz=1000.0, right_hz=2000.0)[None, :]

    cfg_scan = replace(CFG, loop_impl="scan")
    cfg_pal = replace(CFG, loop_impl="pallas")
    coeffs = make_coeffs(cfg_scan)

    _, outs_s = demod_block(cfg_scan, coeffs, demod_init_state(cfg_scan, 1), jnp.asarray(iq))
    _, outs_p = demod_block(cfg_pal, coeffs, demod_init_state(cfg_pal, 1), jnp.asarray(iq))

    # The kernel evaluates the PLL phase detector as wrap(angle(x) + 2pi*t)
    # (exact) while the scan path mirrors the reference's Chebyshev-phasor +
    # atan2 arithmetic (~1e-7/step); through the feedback loop and the
    # harmonic mixers this shows up as ~1e-4 audio differences.  The golden
    # test (83 dB vs the compiled reference) is the accuracy gate.
    np.testing.assert_allclose(
        np.asarray(outs_p["audio"]), np.asarray(outs_s["audio"]), atol=1e-3
    )
    np.testing.assert_array_equal(
        np.asarray(outs_p["rds_valid"]), np.asarray(outs_s["rds_valid"])
    )


def test_demod_block_packed_input_matches_planes():
    """Full demod_block on packed words == plane form (the unpack is exact)."""
    from fm_radio.utils.transfer import pack_iq_u8

    cfg = CFG
    co = make_coeffs(cfg)
    c, b = 1, 65536
    rng = np.random.default_rng(11)
    iq_u8 = rng.integers(0, 256, (c, b, 2)).astype(np.uint8)
    planes = jnp.asarray(
        np.stack([iq_u8[..., 0].astype(np.float32) - 127.0,
                  iq_u8[..., 1].astype(np.float32) - 127.0]))
    w = jnp.asarray(pack_iq_u8(iq_u8))
    st0 = demod_init_state(cfg, c)
    _, outs_p = demod_block(cfg, co, st0, planes)
    _, outs_w = demod_block(cfg, co, st0, w)
    np.testing.assert_allclose(
        np.asarray(outs_w["audio"]), np.asarray(outs_p["audio"]), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(outs_w["rds_pred"]), np.asarray(outs_p["rds_pred"]), atol=1e-5)


def test_demod_block_i8_planes_match_f32_planes():
    """int8-plane ingest == the same samples as f32 planes on the XLA path
    (the int8 -> f32 cast and +1 recenter are exact)."""
    from fm_radio.utils.transfer import split_iq_i8

    co = make_coeffs(CFG)
    c, b = 3, 16384
    rng = np.random.default_rng(12)
    iq_u8 = rng.integers(0, 256, (c, b, 2)).astype(np.uint8)
    i8 = split_iq_i8(iq_u8)
    f32 = i8.astype(np.float32) + 1.0
    st0 = demod_init_state(CFG, c)
    st_i, o_i = demod_block(CFG, co, st0, jnp.asarray(i8))
    st_f, o_f = demod_block(CFG, co, st0, jnp.asarray(f32))
    for k in ("audio", "rds_pred", "rds_valid"):
        np.testing.assert_array_equal(np.asarray(o_i[k]), np.asarray(o_f[k]))
    for a, b_ in zip(jax.tree.leaves(st_i), jax.tree.leaves(st_f)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))
