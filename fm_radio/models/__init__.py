"""The demodulator "models": channel-batched functional pipelines with an
explicit carried-state pytree."""

from fm_radio.models.demod import (  # noqa: F401
    BroadcastFMDemod,
    DemodCoeffs,
    demod_init_state,
)
