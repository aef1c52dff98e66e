"""fm_radio — a broadcast-FM demodulation framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
C++/AVX2 SDR application (williamyang98/FM-Radio): wideband broadcast-FM
stereo demodulation + RDS (Radio Data System) decoding.

Design stance (not a port):
  * Every pipeline stage is a pure function ``f(coeffs, state, x) -> (state', y)``.
  * The channel axis ``C`` is always present — arrays are ``[C, T]`` — so
    multi-station demodulation is free via batching, and sharding over a
    ``jax.sharding.Mesh`` is a partition annotation, not a rewrite.
  * Feed-forward filters (polyphase decimators, FIR/Hilbert) are banded
    matrix products that XLA hands to its GEMM libraries.
  * Linear recurrences (IIR biquads) are blocked Toeplitz products with a
    parallel prefix for the carried state; genuinely nonlinear feedback
    loops (pilot PLL, BPSK symbol sync) are one Pallas GPU kernel each,
    with a ``lax.scan`` reference batched across channels.
  * All cross-block continuity lives in one explicit :class:`DemodState`
    pytree — which is simultaneously the checkpoint format and the
    shard-boundary handoff payload for time-parallel streaming.

Reference parity citations use ``file:line`` into the reference sources.
"""

__version__ = "0.1.0"

from fm_radio.config import (  # noqa: F401
    AnalogParams,
    BPSKConfig,
    DemodConfig,
    RateConfig,
)
