"""Utility subsystem tests: profiler, checkpoint/resume, resampler, mixer."""

import io
import time

import numpy as np
import jax.numpy as jnp

from fm_radio.config import DemodConfig
from fm_radio.io.synth import FMModulator, ModulatorConfig
from fm_radio.models.demod import BroadcastFMDemod, demod_init_state
from fm_radio.ops.resample import linear_resample, mix_sources
from fm_radio.utils.checkpoint import load_state, roundtrip_bytes, save_state
from fm_radio.utils.profiler import Profiler

BLOCK = 16384


def test_profiler_scopes_and_report():
    p = Profiler()
    with p.scope("stage_a", samples=1000):
        time.sleep(0.01)
    with p.scope("stage_a", samples=1000):
        pass
    with p.scope("stage_b"):
        pass
    assert p.stats["stage_a"].calls == 2
    assert p.stats["stage_a"].samples == 2000
    assert p.stats["stage_a"].total_s >= 0.01
    rep = p.report()
    assert "stage_a" in rep and "stage_b" in rep
    buf = io.StringIO()
    import json
    import tempfile, os

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        p.dump_chrome_trace(path)
        trace = json.load(open(path))
        assert len(trace["traceEvents"]) == 3


def test_checkpoint_resume_bit_identical():
    """Kill at a block boundary, reload, outputs continue identically."""
    mod = FMModulator(ModulatorConfig())
    iq = mod.generate(BLOCK * 6, left_hz=1000.0, right_hz=2000.0)
    blocks = iq.reshape(6, BLOCK)

    cfg = DemodConfig()
    d1 = BroadcastFMDemod(cfg, channels=1)
    for b in blocks[:3]:
        d1.process(b[None])
    blob = roundtrip_bytes(d1.state)

    # continue original
    out_ref = [d1.process(b[None])["audio"] for b in blocks[3:]]

    # resume from checkpoint in a fresh instance
    d2 = BroadcastFMDemod(cfg, channels=1)
    d2.state, _ = load_state(io.BytesIO(blob), demod_init_state(cfg, 1))
    out_resumed = [d2.process(b[None])["audio"] for b in blocks[3:]]

    for a, b in zip(out_ref, out_resumed):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_extras(tmp_path):
    cfg = DemodConfig()
    d = BroadcastFMDemod(cfg, channels=2)
    path = str(tmp_path / "ckpt.npz")
    save_state(path, d.state, extra={"block_index": 42})
    state, extras = load_state(path, demod_init_state(cfg, 2))
    assert int(extras["block_index"]) == 42


def test_linear_resample_parity():
    """Match the reference Resample() loop exactly (resampled_pcm_player.cpp:37-54)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((100, 2)).astype(np.float32)
    n_out = 150
    got = np.asarray(linear_resample(jnp.asarray(x), n_out))

    step = 100 / 150
    ref = np.zeros((n_out, 2), np.float32)
    j = 0.0
    for i in range(n_out):
        j0 = int(j)
        j1 = j0 + 1
        f0 = x[j0]
        f1 = x[j1] if j1 < 100 else f0
        k = np.float32(j - j0)
        ref[i] = f0 * (1 - k) + f1 * k
        j += step
    np.testing.assert_allclose(got, ref, atol=5e-5)  # f32 accumulation of j differs


def test_mix_sources():
    s = np.ones((2, 10, 2), np.float32) * 0.4
    out = np.asarray(mix_sources(jnp.asarray(s)))
    expect = np.clip(0.8 / np.log10(20.0), -1, 1)
    np.testing.assert_allclose(out, expect, rtol=1e-5)


def test_lru_cache_semantics():
    from fm_radio.utils.lru import LRUCache

    c = LRUCache(2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1  # refresh 'a'
    c.put("c", 3)  # evicts least-recent 'b'
    assert "b" not in c and c.get("b") is None
    assert c.get("a") == 1 and c.get("c") == 3
    assert c.get_or_create("d", lambda: 4) == 4  # insert evicts 'a'
    assert "a" not in c
    assert c.hits == 3 and c.misses == 2


def test_update_controls_coeff_redesign_is_lru_cached():
    """Toggling between control settings must not re-run the designer pass
    (the reference's dirty-flag UpdateFilters; here an LRU keyed by config)."""
    from fm_radio.models.demod import BroadcastFMDemod

    d = BroadcastFMDemod()
    d.update_controls(use_deemphasis_filter=False)
    off = d.coeffs
    d.update_controls(use_deemphasis_filter=True)
    on = d.coeffs
    d.update_controls(use_deemphasis_filter=False)
    assert d.coeffs is off  # same object: designer not re-run
    d.update_controls(use_deemphasis_filter=True)
    assert d.coeffs is on


def test_pack_iq_u8_23_round_trip():
    """Dense 3-in-2 packing: exact byte round trip through f32 words, and
    residue planes line up with the full-rate planes at stride 3."""
    import numpy as np

    from fm_radio.utils.transfer import (
        pack_iq_u8,
        pack_iq_u8_23,
        unpack_iq_words,
        unpack_iq_words_23,
    )

    rng = np.random.default_rng(7)
    iq = rng.integers(0, 256, size=(3, 96, 2), dtype=np.uint8)

    w23 = pack_iq_u8_23(iq)
    assert w23.shape == (3, 2, 32) and w23.dtype == np.float32
    # every word is an exact 24-bit integer (survives the f32-only boundary)
    assert np.all(w23 == np.round(w23)) and np.all(w23 < 2**24)

    (i0, i1, i2), (q0, q1, q2) = unpack_iq_words_23(w23.swapaxes(0, 1))
    re, im = unpack_iq_words(pack_iq_u8(iq))  # 16-bit packing as oracle
    re, im = np.asarray(re), np.asarray(im)
    for k, (ik, qk) in enumerate(((i0, q0), (i1, q1), (i2, q2))):
        np.testing.assert_array_equal(np.asarray(ik), re[:, k::3])
        np.testing.assert_array_equal(np.asarray(qk), im[:, k::3])


def test_cache_dir_follows_env_var(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache and the program
    sets no other directory."""
    import jax

    from fm_radio.utils import cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.cache_dir() == str(tmp_path)
    assert cache.enable_persistent_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_default_is_inside_checkout(monkeypatch):
    """Unset, the cache is a fixed directory inside the checkout that
    .gitignore lists."""
    import os

    import jax

    from fm_radio.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.cache_dir() == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
    before = jax.config.jax_compilation_cache_dir
    try:
        assert cache.enable_persistent_cache() == cache.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == cache.DEFAULT_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
