"""Source lint: every jnp.dot / jnp.einsum / jnp.matmul outside kernels/
must pass an explicit ``precision=``.

Rationale: the default float32 matmul precision is full f32 on the CPU but
TF32 (a 10-bit mantissa, ~3 decimal digits) on a GPU, so a bare product in
coefficient prep or state propagation is a card-only accuracy bug that the
CPU test backend can never see (this is how the pilot peak resonator lost
~50 dB of golden SNR on an accelerator, see ops/iir._power_stack).  Every
product states the precision it needs: the FIR/IIR filter products take
ops/fir.FIR_PRECISION / ops/iir.IIR_PRECISION, chosen from the audio SNR
measured on the card; coefficient prep, state propagation and the
channelizer's DFT take HIGHEST.  The Pallas loop kernels
(fm_radio/kernels/) contain no matrix products and are exempt.
"""

import ast
import os

import pytest

PKG = os.path.join(os.path.dirname(__file__), "..", "fm_radio")
TARGETS = {"dot", "einsum", "matmul", "tensordot", "vdot"}


# lax-level products and convolutions default to TF32 on a GPU exactly like
# the jnp wrappers; jnp.convolve has no precision= pre-jax-0.4-ish callers
# forget exists; the @ operator is jnp.matmul in disguise.
LAX_TARGETS = {"dot_general", "dot", "conv_general_dilated", "conv",
               "conv_with_general_padding"}
TARGETS_CONV = {"convolve", "correlate"}


def _bare_products(path):
    src = open(path).read()
    tree = ast.parse(src)
    hits = []
    for node in ast.walk(tree):
        # `a @ b` on traced arrays is jnp.matmul with default precision.
        # Only flag when neither operand is an obviously-host numpy value —
        # we can't type-infer, so flag them all; the package currently has
        # zero `@` uses outside kernels/ and that is the desired state.
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            hits.append((node.lineno, "@ (matmul operator)"))
            continue
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = None
        if isinstance(fn, ast.Attribute):
            base = fn.value
            if fn.attr in TARGETS or fn.attr in TARGETS_CONV:
                if isinstance(base, ast.Name) and base.id == "jnp":
                    name = fn.attr
            elif fn.attr in LAX_TARGETS:
                # jax.lax.X or lax.X
                if (isinstance(base, ast.Name) and base.id == "lax") or (
                    isinstance(base, ast.Attribute)
                    and base.attr == "lax"
                    and isinstance(base.value, ast.Name)
                    and base.value.id == "jax"
                ):
                    name = f"lax.{fn.attr}"
        if name is None:
            continue
        kws = {k.arg for k in node.keywords}
        if "precision" not in kws:
            hits.append((node.lineno, name))
    return hits


def test_no_default_precision_products():
    offenders = []
    for root, _, files in os.walk(PKG):
        if os.path.basename(root) == "kernels":
            continue
        for f in files:
            if not f.endswith(".py"):
                continue
            p = os.path.join(root, f)
            for lineno, name in _bare_products(p):
                offenders.append(f"{os.path.relpath(p, PKG)}:{lineno} jnp.{name}")
    assert not offenders, (
        "jnp products without explicit precision= (TF32 by default on a GPU!):\n"
        + "\n".join(offenders)
    )
