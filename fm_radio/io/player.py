"""Real-time audio output: the reference's playback stack
(``src/audio/``: ``PortAudio_Output`` -> ``AudioMixer`` ->
``Resampled_PCM_Player`` -> ``RingBuffer``) re-targeted at a pipe.

This container has no sound hardware (no /dev/snd, no PortAudio), so the
device boundary becomes a child process / file descriptor: any consumer
that reads raw PCM plays the stream (``aplay -f FLOAT_LE -r 48000 -c 2``,
``ffplay -f f32le``, ``pv``, a file).  Everything the reference's audio
layer *computes* is reproduced:

* per-buffer linear-interpolation resampling to the output rate
  (``Resampled_PCM_Player::ConsumeBuffer`` + ``Resample``,
  ``resampled_pcm_player.cpp:15-54`` — the reference carries NO fractional
  phase across buffers; neither do we: per-buffer resampling is the parity
  behavior, seams and all);
* the mixer gain law ``gain / log10(10 * n_sources)`` with [-1, 1] clamp
  (``AudioMixer::UpdateMixer``, ``audio_mixer.cpp:61-80``);
* stream format: interleaved stereo float32 frames, the same sample format
  PortAudio is opened with (``portaudio_output.cpp:35-44``); 16-bit output
  is available for dumb sinks;
* back-pressure: a full OS pipe blocks the producer exactly like the
  reference's cv-guarded ``RingBuffer::ConsumeBuffer``
  (``ring_buffer.h:83-88``).
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np

from fm_radio.io.wav import float_to_int16
from fm_radio.ops.resample import linear_resample

DEFAULT_OUTPUT_RATE = 48_000  # portaudio_output.cpp:8 (Fs = 48000)


class PlayerSinkError(RuntimeError):
    """The audio sink process died (command missing, device error, closed
    pipe) — raised by :meth:`PCMPlayer.consume` instead of a raw
    BrokenPipeError so CLI surfaces can fail with a one-line message."""


class PCMPlayer:
    """Stream stereo float frames to an audio sink process or file object.

    ``command``: shell command whose stdin receives the PCM stream
    (e.g. ``aplay -f FLOAT_LE -r 48000 -c 2``); ``"-"`` or ``fileobj``
    writes to the given binary file object (default stdout) instead.
    """

    def __init__(
        self,
        command: str | None = None,
        fileobj=None,
        output_rate: int = DEFAULT_OUTPUT_RATE,
        gain: float = 1.0,
        fmt: str = "f32",
        n_sources: int = 1,
    ):
        if fmt not in ("f32", "s16"):
            raise ValueError(f"fmt must be f32 or s16, got {fmt!r}")
        self.output_rate = int(output_rate)
        self.gain = float(gain)
        self.fmt = fmt
        # AudioMixer scale: gain / log10(10 * N) == gain at one source
        # (audio_mixer.cpp:61-80)
        self._scale = self.gain / float(np.log10(10.0 * max(n_sources, 1)))
        self.frames_written = 0
        self._proc = None
        if command is not None and command != "-":
            self._proc = subprocess.Popen(
                command, shell=True, stdin=subprocess.PIPE
            )
            self._sink = self._proc.stdin
        elif fileobj is not None:
            self._sink = fileobj
        else:
            self._sink = sys.stdout.buffer

    # -- Resampled_PCM_Player::ConsumeBuffer parity ------------------------

    def consume(self, audio: np.ndarray, input_rate: int) -> int:
        """Play one demodulated block ([N, 2] float, ``input_rate`` Hz).
        Returns frames written at the output rate."""
        audio = np.asarray(audio, np.float32)
        if audio.ndim == 1:
            audio = np.stack([audio, audio], axis=-1)
        n = audio.shape[0]
        if n == 0:
            return 0
        input_rate = int(input_rate)
        if input_rate != self.output_rate:
            # M = int(L * N) exactly as resampled_pcm_player.cpp:22-26
            m = int(self.output_rate / input_rate * n)
            audio = np.asarray(linear_resample(audio, m))
        mixed = np.clip(audio * self._scale, -1.0, 1.0)
        blob = (
            float_to_int16(mixed).astype("<i2").tobytes()
            if self.fmt == "s16"
            else mixed.astype("<f4").tobytes()
        )
        try:
            self._sink.write(blob)
            self._sink.flush()
        except (BrokenPipeError, OSError, ValueError) as e:
            # sink command never started (sh exit 127), audio device error,
            # or consumer closed its end mid-stream
            rc = self._proc.poll() if self._proc is not None else None
            raise PlayerSinkError(
                f"audio sink died after {self.frames_written} frames"
                + (f" (exit status {rc})" if rc is not None else "")
            ) from e
        self.frames_written += mixed.shape[0]
        return mixed.shape[0]

    def close(self) -> int:
        """Flush and close the sink; returns the child's exit code (0 when
        there is no child)."""
        rc = 0
        if self._proc is not None:
            self._proc.stdin.close()
            rc = self._proc.wait()
            self._proc = None
        elif self._sink is not sys.stdout.buffer:
            self._sink.flush()
        return rc

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
