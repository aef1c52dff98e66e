"""Wideband end-to-end step: channelizer -> batched stereo+RDS demod, one jit.

The reference's whole app consumes a WIDEBAND capture (u8 IQ at 1.024 MHz,
app.cpp:39-64) and demodulates the one station its tuner centered
(fm_demod_tuner.cpp:168-177).  The framework's `fmtpu stations` path instead
splits the capture with the polyphase FFT filterbank and demodulates every
station at once — this module is that path as ONE device-resident jittable
step, so its throughput is measurable on the card without host round trips.

Shapes: W wideband captures x M channels/capture -> C = W*M total stations,
per-channel block B = T/M where T is the per-capture wide block.

The channelizer->demod bridge has two formats:
- "i8": the channel planes (unit-gain filterbank, so still on the u8
  grid's scale) are rounded to int8 — the SAME 8-bit quantization the
  radio's own ADC applies to the capture (app.cpp:57-63) — so the demod
  reads 2 bytes per complex sample.  Accuracy is gated end
  to end (tests/test_wideband.py: the bridge costs ~0 dB at station scale
  because the capture was already u8-quantized).
- "f32": exact planes (no re-quantization) — the accuracy oracle.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from fm_radio.models.demod import demod_block, demod_init_state
from fm_radio.parallel.channelizer import channelize_batch_p


def wideband_init_state(cfg, num_channels: int, n_captures: int,
                        taps_per_phase: int = 16) -> dict:
    """Carried state for :func:`wideband_demod_block`: per-capture filterbank
    tails + the [C]-channel demod state pytree."""
    m = num_channels
    n_tail = (taps_per_phase - 1) * m  # matches channelizer_init_state
    zeros = jax.jit(
        lambda: (jnp.zeros((n_captures, n_tail), jnp.float32),) * 2
    )()
    return {
        "chan": zeros,
        "demod": demod_init_state(cfg, n_captures * m),
    }


def wideband_demod_block(cfg, coeffs, ch_taps, state: dict, w_words,
                         num_channels: int, bridge: str = "i8"):
    """One wideband block: [W, T] packed u8 IQ words -> channelize ->
    bridge -> demod_block over all C = W*M stations.

    Returns (state', outs) with demod_block's full outs dict.  ``bridge``
    selects the channel-plane format fed to the demodulator (module
    docstring).
    """
    m = num_channels
    if ch_taps is None:
        from fm_radio.parallel.channelizer import make_channelizer_taps

        ch_taps = make_channelizer_taps(m)
    st = dict(state)
    with jax.named_scope("channelizer"):
        if bridge == "i8":
            # [2, W, M, B] -> [2, C, B] is a free reshape
            st["chan"], y8 = channelize_batch_p(ch_taps, st["chan"], w_words,
                                                m, out="i8")
            x = y8.reshape(2, y8.shape[1] * m, -1)
        else:
            assert bridge == "f32", bridge
            st["chan"], (y_re, y_im) = channelize_batch_p(
                ch_taps, st["chan"], w_words, m)
            c = y_re.shape[0] * m
            x = jnp.stack([y_re.reshape(c, -1), y_im.reshape(c, -1)])
    st["demod"], outs = demod_block(cfg, coeffs, st["demod"], x)
    return st, outs
