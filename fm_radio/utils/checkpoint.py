"""Checkpoint / resume: serialize the complete stream-processing state.

The reference cannot resume a stream mid-file — all continuity lives in
C++ members (SURVEY.md §5.4).  Here the device state is one pytree
(:func:`demod_init_state`) and the host RDS state is a few scalars + byte
buffers, so a checkpoint is a flat .npz.  The same mechanism serves
shard-boundary state handoff and elastic restart: kill the process at any
block boundary, reload, and the output continues bit-identically.
"""

from __future__ import annotations

import io

import numpy as np
import jax

from fm_radio.utils.transfer import fetch

_SEP = "/"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_asdict"):  # NamedTuple
        items = tree._asdict().items()
    else:
        return {prefix.rstrip(_SEP): tree}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    return out


def state_to_arrays(state) -> dict:
    """Device state pytree -> {path: numpy array} (f32-safe fetch)."""
    flat = _flatten(state)
    return {k: fetch(v) for k, v in flat.items()}


def save_state(path_or_file, state, extra: dict | None = None) -> None:
    """Save device state (+ optional host-side extras) to .npz."""
    arrays = state_to_arrays(state)
    if extra:
        for k, v in extra.items():
            arrays[f"__extra__{_SEP}{k}"] = np.asarray(v)
    np.savez(path_or_file, **arrays)


def load_state(path_or_file, template) -> tuple:
    """Load a checkpoint into the structure of ``template`` (a state pytree
    from :func:`demod_init_state`).  Returns (state, extras dict)."""
    data = np.load(path_or_file, allow_pickle=False)
    extras = {}
    arrays = {}
    for k in data.files:
        if k.startswith(f"__extra__{_SEP}"):
            extras[k.split(_SEP, 1)[1]] = data[k]
        else:
            arrays[k] = data[k]

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}{_SEP}") for k, v in tree.items()}
        if hasattr(tree, "_asdict"):
            vals = {
                k: rebuild(v, f"{prefix}{k}{_SEP}") for k, v in tree._asdict().items()
            }
            return type(tree)(**vals)
        arr = arrays[prefix.rstrip(_SEP)]
        # restore on device with the template's dtype via a jitted cast so
        # non-f32 leaves never cross the host boundary as such
        import jax.numpy as jnp

        target_dtype = tree.dtype
        if np.issubdtype(target_dtype, np.complexfloating):
            ri = np.stack([arr.real, arr.imag]).astype(np.float32)
            return jax.jit(lambda t: jax.lax.complex(t[0], t[1]))(jnp.asarray(ri))
        host = arr.astype(np.float32)
        return jax.jit(lambda t: t.astype(target_dtype))(jnp.asarray(host))

    return rebuild(template), extras


def roundtrip_bytes(state, extra=None) -> bytes:
    buf = io.BytesIO()
    save_state(buf, state, extra)
    return buf.getvalue()
