"""Pallas (Triton) GPU kernels for the sequential hot loops.

The two per-sample feedback loops (pilot PLL at fs_fm_out, BPSK sync at
fs_rds) cannot be parallelised over time.  Under ``lax.scan`` each step is
one or more XLA launches; these kernels run the whole loop inside one
launch with the carry in registers — the GPU counterpart of the
reference's hand-written AVX loops (``src/dsp/simd/``).
"""

from fm_radio.kernels.pll_pallas import pilot_pll_pallas  # noqa: F401
from fm_radio.kernels.bpsk_pallas import bpsk_sync_pallas  # noqa: F401
