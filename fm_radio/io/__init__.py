"""Input/output: recorded-IQ readers, WAV sinks, and a software broadcast-FM
modulator used as a synthetic signal source for end-to-end tests."""

from fm_radio.io.pcm import iter_pcm_blocks, read_pcm_u8  # noqa: F401
from fm_radio.io.wav import write_wav_int16  # noqa: F401
from fm_radio.io.synth import FMModulator, ModulatorConfig  # noqa: F401
