"""IIR filters as parallel linear recurrences.

The reference evaluates its order-1/2 IIR filters sample-by-sample
(``iir_filter.h:41-46``).  A sequential loop is the one thing a parallel
accelerator must not do, so the default here reformulates the recurrence as an associative scan on
affine maps: with state s[n] = (y[n], ..., y[n-r+1]),

    s[n] = A s[n-1] + u[n],   u[n] = (ff[n], 0, ...),

where ff is the feed-forward FIR part (fully parallel) and A the companion
matrix of the denominator.  Affine maps compose associatively, so
``jax.lax.associative_scan`` evaluates the whole block in O(log N) depth.  A `lax.scan` reference implementation is kept for parity testing.

Coefficients are real (SciPy convention, see ``ops/design.py``); complex
signals are filtered by stacking real/imag as channels — identical math since
the reference's complex IIR also uses real taps (``iir_filter.h:8-10``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from fm_radio.ops.fir import filter_precision


# Toeplitz-matmul precision: the FIR stages' choice (ops/fir.FIR_PRECISION,
# bf16x3 on a GPU, HIGHEST on the CPU via filter_precision).  The
# tile-to-tile STATE propagation stays HIGHEST either way, so error does
# not compound across tiles.
IIR_PRECISION = jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3


def iir_init_state(channels: int, order: int, dtype=jnp.float32) -> dict:
    """State: last ``order`` inputs and outputs (zeros at start,
    ``iir_filter.h:24-31``).  x_hist[:, 0] is the newest."""
    return {
        "x_hist": jnp.zeros((channels, order), dtype=dtype),
        "y_hist": jnp.zeros((channels, order), dtype=dtype),
    }


def _feedforward(b: jnp.ndarray, x_hist: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """ff[n] = sum_j b[j] x[n-j] with carried history (x_hist newest-first)."""
    order = b.shape[0] - 1
    if order == 0:
        return b[0] * x
    x_pad = jnp.concatenate([x_hist[:, ::-1], x], axis=-1)  # oldest..newest
    # correlation with reversed b
    w = b[::-1]
    n = x.shape[-1]
    acc = jnp.zeros_like(x)
    for j in range(order + 1):
        acc = acc + w[j] * jax.lax.dynamic_slice_in_dim(x_pad, j, n, axis=-1)
    return acc


def _companion(a: jnp.ndarray) -> jnp.ndarray:
    """Companion matrix of denominator a (a[0]==1), order r = len(a)-1."""
    r = a.shape[0] - 1
    top = -a[1:][None, :]  # [1, r]
    if r == 1:
        return top.reshape(1, 1)
    eye = jnp.eye(r - 1, r, dtype=a.dtype)
    return jnp.concatenate([top, eye], axis=0)  # [r, r]


def _power_stack(amat: jnp.ndarray, n: int) -> jnp.ndarray:
    """[n+1, r, r] stack of matrix powers A^0..A^n, built by doubling.

    Precision MUST be explicit: these tiny [r, r] products run at the
    backend's default matmul precision otherwise — TF32 on a GPU — and a
    2^-8-level perturbation of the pilot peak filter's pole (r=0.9999,
    ~4 Hz bandwidth at 128 kHz) detunes the resonance by ~0.1 Hz, which
    is DEGREES of pilot phase on the resonance skirt (measured: ~1e-2
    cycles of theta error end-to-end before this fix)."""
    hi = jax.lax.Precision.HIGHEST
    r = amat.shape[0]
    stack = jnp.eye(r, dtype=amat.dtype)[None]
    p = amat
    while stack.shape[0] < n + 1:
        stack = jnp.concatenate(
            [stack, jnp.einsum("ij,njk->nik", p, stack, precision=hi)], axis=0
        )
        p = jnp.matmul(p, p, precision=hi)
    return stack[: n + 1]


def _iir_toeplitz(b, a, amat, x, x_hist, s_prev, chunk):
    """Exact blocked IIR y = b/a applied to x, directly on the INPUT.

    Within each length-``chunk`` tile the zero-state response is one
    matmul against the lower-triangular Toeplitz matrix of the FULL impulse
    response h[k] = sum_j b[j] g[k-j] (g[k] = (A^k)[0,0] the recursive part)
    — the feed-forward FIR is folded into the matrix, so the intermediate
    ``ff`` array of the textbook two-step form is never materialized (one
    full device-memory round trip saved).  Tile-to-tile state propagation is a
    Kogge-Stone prefix over ~n/chunk tiny r-vectors.  This is the parallel
    form of ``IIR_Filter::process`` (iir_filter.h:41-46): O(chunk) redundant
    matmul FLOPs instead of O(n) serial steps.

    x_hist: [C, order_b] carried inputs newest-first; s_prev: [C, r] carried
    outputs newest-first.
    """
    c, n = x.shape
    r = amat.shape[0]
    ob = b.shape[0] - 1
    l = chunk
    t = -(-n // l)
    pad = t * l - n
    if pad:
        x = jnp.pad(x, ((0, 0), (0, pad)))

    stack = _power_stack(amat, l)  # [L+1, r, r]
    g = stack[:l, 0, 0]  # recursive impulse response, [L]
    # full impulse response h = b * g (causal convolution, truncated at L)
    h = jnp.zeros((l,), g.dtype)
    for j in range(ob + 1):
        h = h.at[j:].add(b[j] * g[: l - j])
    ii = jnp.arange(l)
    dmat = ii[:, None] - ii[None, :]
    t_mat = jnp.where(dmat >= 0, jnp.take(h, jnp.clip(dmat, 0, l - 1)), 0.0)
    p_mat = stack[1 : l + 1, 0, :]  # [L, r]: y-initial-condition responses
    a_l = stack[l]

    xc = x.reshape(c, t, l)
    # Zero-state response of every tile: ONE Toeplitz matmul.
    y_zs = jnp.einsum("ctl,ml->ctm", xc, t_mat,
                      precision=filter_precision(IIR_PRECISION))

    if ob > 0:
        # x-halo: inputs x[-1..-ob] relative to each tile contribute
        # hm[q, i] = sum_j b[j] g[i - j + q + 1] (input q+1 samples back).
        hm = jnp.zeros((ob, l), g.dtype)
        for q in range(ob):
            for j in range(q + 1, ob + 1):
                k0 = j - q - 1  # g index offset at i=0
                hm = hm.at[q, :].add(
                    b[j] * jnp.where(ii - k0 >= 0, jnp.take(
                        g, jnp.clip(ii - k0, 0, l - 1)), 0.0)
                )
        # xh[c, t, q] = x[c, t*L - 1 - q]; tile 0 from carried x_hist
        xh_bulk = jnp.stack(
            [xc[:, :-1, l - 1 - q] for q in range(ob)], axis=-1
        )  # [c, t-1, ob]
        xh0 = x_hist[:, :ob][:, None, :]  # [c, 1, ob] newest-first
        xh = jnp.concatenate([xh0, xh_bulk], axis=1)  # [c, t, ob]
        y_zs = y_zs + jnp.einsum("ctq,ql->ctl", xh, hm,
                                 precision=jax.lax.Precision.HIGHEST)

    cvec = y_zs[:, :, l - 1 - jnp.arange(r)]  # [c, t, r] newest-first
    # Tile-entry states obey their own linear recurrence
    #     s_in[t] = A^L s_in[t-1] + cvec[t-1],   s_in[0] = s_prev,
    # evaluated as a Kogge-Stone prefix over the t tiles: log2(t) passes over
    # a [C, t, r] array (KBs).  (A previous formulation materialized the full
    # [t, t, r, r] power tensor via gather + dense einsum — O(t^2) work and a
    # gather on the critical path; the prefix is ~100x cheaper.)
    s = jnp.zeros((c, t, r), dtype=x.dtype)
    s = s.at[:, 1:, :].set(cvec[:, :-1, :])
    s = s.at[:, 0, :].set(s_prev)
    hi_p = jax.lax.Precision.HIGHEST
    d = 1
    a_d = a_l
    while d < t:
        upd = jnp.einsum("ij,cnj->cni", a_d, s[:, :-d, :], precision=hi_p)
        s = s.at[:, d:, :].add(upd)
        a_d = jnp.matmul(a_d, a_d, precision=hi_p)
        d *= 2
    s_in = s
    y = y_zs + jnp.einsum("ctj,mj->ctm", s_in, p_mat, precision=hi_p)
    return y.reshape(c, t * l)[:, :n]


@functools.partial(jax.jit, static_argnames=("method",))
def iir_filter(b, a, state: dict, x: jnp.ndarray, method: str = "toeplitz"):
    """Apply IIR filter (SciPy convention) along the last axis of ``x`` [C, N].

    Returns ``(new_state, y)``.  ``method``:
      "toeplitz" (default) — exact blocked recurrence: chunked
        lower-triangular-Toeplitz matmuls (see _iir_toeplitz).
      "kogge" — Kogge-Stone prefix on companion-matrix powers: log2(N)
        elementwise passes over a [C, N, r] state array.
      "assoc" — generic associative scan on affine pairs.
      "scan"  — sequential lax.scan oracle (reference arithmetic order).
    """
    b = jnp.asarray(b, jnp.float32)
    a = jnp.asarray(a, jnp.float32)
    r = a.shape[0] - 1
    assert r >= 1
    c, n = x.shape

    if method == "toeplitz" and n >= 32:
        amat = _companion(a)
        y = _iir_toeplitz(
            b, a, amat, x, state["x_hist"], state["y_hist"], chunk=min(256, n)
        )
        y_hist = y[:, -1 : -r - 1 : -1]
        if y_hist.shape[-1] < r:  # short block: keep tail of old history
            y_hist = jnp.concatenate(
                [y_hist, state["y_hist"][:, : r - y_hist.shape[-1]]], axis=-1
            )
    elif method == "scan":
        ff = _feedforward(b, state["x_hist"], x)  # [C, N]

        def step(y_hist, ff_n):
            # y_hist: [C, r] newest-first
            y_n = ff_n - jnp.einsum("j,cj->c", a[1:], y_hist,
                                    precision=jax.lax.Precision.HIGHEST)
            y_hist = jnp.concatenate([y_n[:, None], y_hist[:, :-1]], axis=1)
            return y_hist, y_n

        y_hist, y_t = jax.lax.scan(step, state["y_hist"], ff.T)
        y = y_t.T
    elif method in ("kogge", "toeplitz"):  # toeplitz falls back here for tiny n
        ff = _feedforward(b, state["x_hist"], x)  # [C, N]
        amat = _companion(a)  # [r, r]
        s = jnp.zeros((c, n, r), dtype=ff.dtype).at[:, :, 0].set(ff)
        hi_p = jax.lax.Precision.HIGHEST
        s = s.at[:, 0, :].add(
            jnp.einsum("ij,cj->ci", amat, state["y_hist"], precision=hi_p)
        )
        d = 1
        a_d = amat
        while d < n:
            upd = jnp.einsum("ij,cnj->cni", a_d, s[:, :-d, :], precision=hi_p)
            s = s.at[:, d:, :].add(upd)
            a_d = jnp.matmul(a_d, a_d, precision=hi_p)
            d *= 2
        y = s[:, :, 0]
        y_hist = s[:, -1, :]
    else:
        ff = _feedforward(b, state["x_hist"], x)  # [C, N]
        amat = _companion(a)  # [r, r]
        u = jnp.zeros((c, n, r), dtype=ff.dtype).at[:, :, 0].set(ff)
        # fold initial condition into u[0]
        s_prev = state["y_hist"]  # [C, r] newest-first = (y[-1], ..., y[-r])
        hi_p = jax.lax.Precision.HIGHEST
        u = u.at[:, 0, :].add(
            jnp.einsum("ij,cj->ci", amat, s_prev, precision=hi_p)
        )
        amats = jnp.broadcast_to(amat, (c, n, r, r))

        def combine(left, right):
            a1, u1 = left
            a2, u2 = right
            return (
                jnp.einsum("...ij,...jk->...ik", a2, a1, precision=hi_p),
                jnp.einsum("...ij,...j->...i", a2, u1, precision=hi_p) + u2,
            )

        _, s = jax.lax.associative_scan(combine, (amats, u), axis=1)
        y = s[:, :, 0]
        y_hist = s[:, -1, :]

    order_b = b.shape[0] - 1
    if order_b > 0:
        x_hist = x[:, -1 : -order_b - 1 : -1]  # newest-first
        if x_hist.shape[-1] < order_b:  # short block: keep old history
            pad = state["x_hist"][:, : order_b - x_hist.shape[-1]]
            x_hist = jnp.concatenate([x_hist, pad], axis=-1)
    else:
        x_hist = state["x_hist"]
    return {"x_hist": x_hist, "y_hist": y_hist}, y


def iir_filter_planes(b, a, state_ri: dict, xp, method: str = "toeplitz"):
    """Real-coefficient IIR on a plane-tuple complex signal xp = (re, im).

    ``state_ri`` holds stacked [2C, order] histories (re rows then im rows).
    Filters the planes as two independent real streams — no [2C, T] concat.
    """
    xr, xi = xp
    c = xr.shape[0]
    st_r = {k: v[:c] for k, v in state_ri.items()}
    st_i = {k: v[c:] for k, v in state_ri.items()}
    st_r, yr = iir_filter(b, a, st_r, xr, method=method)
    st_i, yi = iir_filter(b, a, st_i, xi, method=method)
    new = {k: jnp.concatenate([st_r[k], st_i[k]], axis=0) for k in st_r}
    return new, (yr, yi)


def iir_filter_complex(b, a, state_ri: dict, x: jnp.ndarray, method: str = "toeplitz"):
    """Real-coefficient IIR on a complex signal: filter re/im independently.

    ``state_ri`` holds stacked [2C, order] histories.
    """
    state_ri, (yr, yi) = iir_filter_planes(
        b, a, state_ri, (x.real, x.imag), method=method
    )
    return state_ri, jax.lax.complex(yr, yi)
