"""Host<->device transfer helpers and the IQ ingest formats.

The capture's native format is interleaved u8 IQ (app.cpp:57-63).  It
reaches the device in one of two exact forms: int8 planes
(:func:`split_iq_i8`, 2 bytes per complex sample) or packed f32 words
(:func:`pack_iq_u8`, 4 bytes).  Both are decoded inside the jitted demod,
where the cast fuses into the front end's first pass.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def device_put_complex(x: np.ndarray) -> jnp.ndarray:
    """Host complex -> device complex64."""
    return jnp.asarray(np.asarray(x, np.complex64))


def fetch(x) -> np.ndarray:
    """Device array (or host array) -> host numpy."""
    return np.asarray(x)


def fetch_tree(tree):
    return jax.tree.map(fetch, tree)


def take_rows(y: jnp.ndarray, select) -> jnp.ndarray:
    """Row-select a device array with host indices."""
    return jnp.take(y, jnp.asarray(np.asarray(select, np.int32)), axis=0)


def init_on_device(init_fn, *args, **static_kwargs):
    """Run a zeros/constants-building init function inside jit, so every
    leaf is created on the device in one launch."""
    return jax.jit(functools.partial(init_fn, *args, **static_kwargs))()


def pack_iq_u8(iq_u8: np.ndarray) -> np.ndarray:
    """Pack raw interleaved u8 IQ into one f32 word per complex sample.

    iq_u8: [..., N, 2] (I, Q byte pairs, the radio's native capture format,
    app.cpp:57-63).  Returns [..., N] f32 with w = I*256 + Q — exact
    integers < 2^16 at HALF the bytes of (re, im) f32 planes;
    :func:`unpack_iq_words` recenters by -127 on the device.
    """
    iq = np.asarray(iq_u8)
    assert iq.shape[-1] == 2 and iq.dtype == np.uint8
    w = iq[..., 0].astype(np.float32)
    w *= 256.0
    w += iq[..., 1]
    return w


def unpack_iq_words(w):
    """Inverse of :func:`pack_iq_u8` as traceable arithmetic: packed words
    -> centered (re, im) f32.
    Exact: *2^-8, floor and the subtractions are error-free on integers
    < 2^16."""

    ihi = jnp.floor(w * jnp.float32(1.0 / 256.0))
    return ihi - 127.0, (w - ihi * 256.0) - 127.0


def split_iq_i8(iq_u8: np.ndarray) -> np.ndarray:
    """Raw 8-bit ingest planes: u8 IQ -> [2, ..., N] int8 of (I-128, Q-128).

    The radio's native bytes travel and live in device memory at 2 bytes
    per complex sample — HALF the packed-f32-word form.  The shift is -128
    (not the reference's -127, app.cpp:57-63) because 255-127 = 128
    overflows int8; :func:`i8_planes_to_f32` adds the +1 back after the
    f32 cast.
    """
    iq = np.asarray(iq_u8)
    assert iq.shape[-1] == 2 and iq.dtype == np.uint8
    planes = np.moveaxis(iq, -1, 0).astype(np.int16) - 128
    return np.ascontiguousarray(planes.astype(np.int8))


def i8_planes_to_f32(x8):
    """Traceable inverse of :func:`split_iq_i8` -> centered (re, im) f32
    planes (u8 - 127, app.cpp:57-63)."""

    def f(p):
        return p.astype(jnp.float32) + 1.0

    return f(x8[0]), f(x8[1])


def pack_iq_u8_23(iq_u8: np.ndarray) -> np.ndarray:
    """Dense 3-samples-in-2-words packing: 2/3 the bytes of pack_iq_u8.

    f32 carries 24-bit integers exactly, so one word can hold THREE bytes
    (pack_iq_u8 uses only 16 of them).  Layout is chosen so stride-3
    RESIDUE subsequences come out with pure elementwise arithmetic — no
    interleave:

      iq_u8: [..., N, 2] with N % 3 == 0.  Returns [..., 2, N/3] f32 where
        out[0, t] = I[3t]*2^16 + I[3t+1]*2^8 + I[3t+2]   (I-plane words)
        out[1, t] = Q[3t]*2^16 + Q[3t+1]*2^8 + Q[3t+2]   (Q-plane words)

    Each byte FIELD of a word stream is one residue subsequence: field k of
    out[p, :] is plane p's samples at time 3t+k, already in time order
    within the residue.  See unpack_iq_words_23.
    """
    iq = np.asarray(iq_u8)
    assert iq.shape[-1] == 2 and iq.dtype == np.uint8
    n = iq.shape[-2]
    assert n % 3 == 0, "dense packing needs N % 3 == 0"
    tri = iq.reshape(*iq.shape[:-2], n // 3, 3, 2).astype(np.float32)
    w = tri[..., 0, :] * 65536.0 + tri[..., 1, :] * 256.0 + tri[..., 2, :]
    # [..., N/3, 2] -> [..., 2, N/3]
    return np.moveaxis(w, -1, -2)


def unpack_iq_words_23(w):
    """Traceable inverse of :func:`pack_iq_u8_23` -> centered residue planes.

    w: [2, ..., T] (I-words, Q-words).  Returns ((i0, i1, i2), (q0, q1, q2)),
    six f32 arrays of shape [..., T]: plane residues, where ik[t] is
    I[3t+k] - 127.  All arithmetic exact on integers < 2^24.
    """

    def fields(words):
        b0 = jnp.floor(words * jnp.float32(1.0 / 65536.0))
        rem = words - b0 * 65536.0
        b1 = jnp.floor(rem * jnp.float32(1.0 / 256.0))
        b2 = rem - b1 * 256.0
        return b0 - 127.0, b1 - 127.0, b2 - 127.0

    return fields(w[0]), fields(w[1])
