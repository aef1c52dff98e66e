"""Benchmark: aggregate IQ throughput of the full stereo+RDS demod chain.

Method: C channels x B-sample blocks of FM-like IQ (constant envelope,
random phase walk, quantized to the u8 grid and carried as int8 planes,
the default ingest), made on the device.  A jitted ``lax.scan`` demodulates
``n_blocks`` blocks with the state carried across blocks, exactly as in
streaming.  The metric is aggregate IQ megasamples per second on one card;
1.024 MS/s is one station in real time.

Runs only on a GPU and exits non-zero elsewhere.  Every result names the
device and the card's power limit.  ``--trace DIR`` also records a profiler
trace of one more run and prints each stage's device time (the
``jax.named_scope`` names of models/demod.py) and the device idle share.

    python bench.py [--channels 2048] [--block 131072] [--n-blocks 8]
                    [--loop-impl auto|pallas|scan] [--trace DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import time


def make_input(channels: int, block: int, seed: int = 0):
    """[2, C, B] int8 planes of an FM-like signal, made on the device."""
    import jax
    import jax.numpy as jnp

    ph = jnp.cumsum(
        0.5 * jax.random.normal(jax.random.PRNGKey(seed), (channels, block)),
        axis=-1)
    # u8 capture values 127 + round(100 e^{j ph}) as (u8 - 128) planes
    return jnp.stack([jnp.round(100.0 * jnp.cos(ph)) - 1.0,
                      jnp.round(100.0 * jnp.sin(ph)) - 1.0]).astype(jnp.int8)


def make_run(cfg, coeffs, n_blocks: int):
    """Jitted scan of demod_block over n_blocks repeats of one input."""
    import jax
    import jax.numpy as jnp

    from fm_radio.models.demod import demod_block

    @jax.jit
    def run(state, x):
        def step(st, _):
            st, outs = demod_block(cfg, coeffs, st, x)
            return st, (jnp.sum(outs["audio"])
                        + jnp.sum(outs["rds_pred"])
                        + jnp.sum(outs["rds_valid"].astype(jnp.float32)))

        state, probes = jax.lax.scan(step, state, None, length=n_blocks)
        return state, jnp.sum(probes)

    return run


def time_run(run, state, x, reps: int = 3) -> float:
    """Best wall time of ``reps`` runs after one warm-up (compile) run."""
    import jax

    jax.block_until_ready(run(state, x))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(state, x))
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--channels", type=int, default=2048)
    ap.add_argument("--block", type=int, default=131072)
    ap.add_argument("--n-blocks", type=int, default=8)
    ap.add_argument("--loop-impl", default="auto",
                    choices=("auto", "pallas", "scan"))
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="also trace one run and print per-stage device time")
    args = ap.parse_args(argv)
    if args.trace:
        # XLA wraps kernels in command buffers (CUDA graphs), whose trace
        # events lose the HLO op each kernel came from; the traced process
        # launches op by op so every kernel maps to its named_scope stage.
        # Set before JAX starts; it applies to this whole process, so its
        # throughput line is labelled with it.
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_gpu_enable_command_buffer=")

    from fm_radio.utils.cache import enable_persistent_cache
    from fm_radio.utils.gpu import card_line, require_gpu

    enable_persistent_cache()
    device = require_gpu()
    card = card_line()
    print(f"device: {device}  card: {card}", flush=True)

    from fm_radio.config import DemodConfig
    from fm_radio.models.demod import demod_init_state, make_coeffs

    cfg = DemodConfig(loop_impl=args.loop_impl)
    coeffs = make_coeffs(cfg)
    x = make_input(args.channels, args.block)
    state = demod_init_state(cfg, args.channels)
    run = make_run(cfg, coeffs, args.n_blocks)

    t0 = time.perf_counter()
    compiled = run.lower(state, x).compile()
    compile_s = time.perf_counter() - t0
    best = time_run(run, state, x)
    samples = args.channels * args.block * args.n_blocks
    result = {
        "metric": "full-chain IQ demod throughput (stereo+RDS), one card",
        "value": samples / best / 1e6,
        "unit": "Msamples/s",
        "ms_per_block": best / args.n_blocks * 1e3,
        "channels": args.channels,
        "block": args.block,
        "n_blocks": args.n_blocks,
        "loop_impl": args.loop_impl,
        "compile_s": compile_s,
        "device": device,
        "card": card,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }
    if args.trace:
        import jax

        from fm_radio.utils.gpu import dump_trace_sample, stage_device_times

        with jax.profiler.trace(args.trace):
            jax.block_until_ready(run(state, x))
        hlo = compiled.as_text()
        with open(os.path.join(args.trace, "hlo.txt"), "w") as f:
            f.write(hlo)
        dump_trace_sample(args.trace, os.path.join(args.trace,
                                                   "trace_sample.txt"))
        trace = stage_device_times(args.trace, hlo)
        trace["stage_ms_per_block"] = {
            k: v / args.n_blocks for k, v in trace.pop("stage_ms").items()}
        result["trace"] = trace
    print(json.dumps(result))


if __name__ == "__main__":
    main()
