"""DSP primitive ops: windowed-sinc/IIR designers, polyphase decimators,
FIR/Hilbert, IIR (sequential + parallel associative scan), AGC, discriminator,
harmonic mixer, spectra.  Each op is a pure function with explicit carried
state, batched over a leading channel axis."""

from fm_radio.ops.design import (  # noqa: F401
    create_fir_bpf,
    create_fir_hilbert,
    create_fir_hpf,
    create_fir_lpf,
    create_iir_notch_filter,
    create_iir_peak_1_filter,
    create_iir_peak_2_filter,
    create_iir_single_pole_lpf,
    prewarp_normalised_frequency,
)
from fm_radio.ops.windows import (  # noqa: F401
    window_blackman,
    window_blackman_harris,
    window_hamming,
    window_hann,
)
from fm_radio.ops.cmath import chebyshev_sine, cheb_phasor, wrap_phase  # noqa: F401
from fm_radio.ops.fir import (  # noqa: F401
    fir_filter,
    fir_init_state,
    hilbert_fir,
    hilbert_init_state,
    polyphase_decimate,
    polyphase_init_state,
)
from fm_radio.ops.iir import iir_filter, iir_init_state  # noqa: F401
from fm_radio.ops.agc import agc_process, agc_init_state  # noqa: F401
from fm_radio.ops.discriminator import fm_discriminate  # noqa: F401
from fm_radio.ops.mixer import apply_harmonic_pll  # noqa: F401
