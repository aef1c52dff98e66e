"""``fmtpu`` — the framework's CLI, mirroring the reference executables.

    python -m fm_radio.apps.cli demod      -i in.pcm [-b 65536] [--taps out/]
    python -m fm_radio.apps.cli scrape     -i in.pcm -o outdir [-b 65536]
    python -m fm_radio.apps.cli tune       -i wide.pcm -r 8192000 -f 1024000 -o outdir
    python -m fm_radio.apps.cli rds-decode -i bytes.bin
    python -m fm_radio.apps.cli bench      -i in.pcm [-b 65536] [-c 64]
    python -m fm_radio.apps.cli channelize -i wide.pcm -o outdir -m 16
    python -m fm_radio.apps.cli stations   -i wide.pcm -o outdir -m 8 --select 1,5 | --auto
    python -m fm_radio.apps.cli scan       -i wide.pcm -m 8 [--seconds 1.0]
    python -m fm_radio.apps.cli monitor    -i in.pcm [--refresh 4] [--no-ansi]
    python -m fm_radio.apps.cli synth      -o out.pcm [--ps NAME --rt TEXT --af 87.6] [--stations K -m M]
    python -m fm_radio.apps.cli selftest   [--seconds 2.0] [--cnr 30]

Flag parity: ``-i`` input (stdin if omitted where meaningful), ``-b`` block
size power-of-2-ceiled (``fm_demod_no_tuner.cpp:95-129``), ``-o`` output dir
(``fm_demod_scraper.cpp``).  The GUI is replaced by ``--taps``: every named
intermediate buffer (broadcast_fm_demod.h:240-268) dumped as .npy.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def power_ceil(x: int) -> int:
    """Round up to a power of two (fm_demod_no_tuner.cpp:95-101)."""
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


from fm_radio.utils.transfer import pack_iq_u8


def _read_input_u8(path: str | None, max_samples: int | None = None) -> np.ndarray:
    if path is None or path == "-":
        raw = np.frombuffer(sys.stdin.buffer.read(), dtype=np.uint8)
    else:
        raw = np.fromfile(path, dtype=np.uint8)
    n = raw.size // 2
    if max_samples:
        n = min(n, max_samples)
    return raw[: 2 * n].reshape(n, 2)


def _packed_input(path: str | None, max_samples: int | None = None):
    """Packed wideband input: a lazily-packing memmap view for file inputs
    (constant host memory — hour-long multi-channel captures stream in
    O(chunk)); stdin falls back to a full read."""
    if path not in (None, "-"):
        from fm_radio.io.pcm import LazyPackedPcm

        try:
            return LazyPackedPcm(path, max_samples)
        except (OSError, ValueError):
            # empty files and special files (/dev/null, pipes) can't be
            # memmapped: fall back to an eager read
            pass
    return pack_iq_u8(_read_input_u8(path, max_samples))


def _i8_input(path: str | None, max_samples: int | None = None):
    """int8-plane input ([2, 1, N] of I-128/Q-128, utils/transfer.
    split_iq_i8): the default ingest — half the packed-word bytes on the
    host link and in device memory.  File inputs are a lazily-splitting
    memmap view (O(chunk) host memory); stdin falls back to a full read."""
    if path not in (None, "-"):
        from fm_radio.io.pcm import LazyI8Pcm

        try:
            return LazyI8Pcm(path, max_samples)
        except (OSError, ValueError):
            pass
    from fm_radio.utils.transfer import split_iq_i8

    return split_iq_i8(_read_input_u8(path, max_samples))[:, None, :]


def _single_channel_ingest(args, cfg):
    """(cfg, input view) per --ingest: "i8" (default) int8 planes, "f32w"
    packed f32 words.  Both carry the capture's exact u8 values."""
    if args.ingest == "i8":
        return cfg, _i8_input(args.input)
    return cfg, _packed_input(args.input)


def cmd_demod(args) -> None:
    import dataclasses

    from fm_radio.config import DemodConfig
    from fm_radio.io.wav import write_wav_int16
    from fm_radio.models.app import App

    # runtime demod controls — the reference's GUI sliders/combos
    # (render_fm_demod.cpp:305-374) as flags
    cfg = DemodConfig()
    changes = {}
    if args.audio_mode != "stereo":
        changes["audio_out"] = args.audio_mode
    if args.deemphasis_us:
        changes["use_deemphasis_filter"] = True
        changes["deemphasis_cutoff_us"] = int(args.deemphasis_us)
    if args.lpr_cutoff_hz:
        changes["audio_lpr_cutoff_hz"] = int(args.lpr_cutoff_hz)
    if args.lmr_cutoff_hz:
        changes["audio_lmr_cutoff_hz"] = int(args.lmr_cutoff_hz)
    if args.stereo_gain is not None:
        changes["audio_stereo_mix_factor"] = float(args.stereo_gain)
    if changes:
        cfg = dataclasses.replace(cfg, **changes)

    block = power_ceil(args.block_size)
    # --play - streams raw PCM on stdout: every informational line must go
    # to stderr or it corrupts the byte stream mid-playback
    info_out = sys.stderr if args.play == "-" else sys.stdout
    # ingest: int8 planes by default (2 B/sample on the host link and in
    # device memory), packed f32 words via --ingest f32w.  File
    # inputs are a lazy memmap view fed in chunks: O(chunk) host memory
    # for arbitrarily long captures
    cfg, iq = _single_channel_ingest(args, cfg)
    n_in = len(iq)
    app = App(block_size=block, cfg=cfg, channels=1,
              decode_rds=not args.no_rds,
              strict_ref=args.strict_ref)
    if args.resume_state:
        from fm_radio.models.demod import demod_init_state
        from fm_radio.utils.checkpoint import load_state

        app.demod.state, extras = load_state(
            args.resume_state, demod_init_state(app.demod.cfg, 1)
        )
        print(
            f"resumed from {args.resume_state} "
            f"(block_index={int(extras.get('block_index', -1))})",
            file=sys.stderr,
        )
    start_block = 0
    off = 0
    if args.resume_state and args.resume_seek:
        # crash-restart on the SAME input: skip the blocks the checkpoint
        # already covers (SURVEY §5.3/5.4 — restart-from-block)
        start_block = int(extras.get("block_index", 0))
        print(f"seeking past {start_block} checkpointed blocks", file=sys.stderr)
        off = min(start_block * block, n_in)
    avail_blocks = (n_in - off) // block

    if args.checkpoint_every and args.save_state:
        # periodic checkpointing: atomic save every N blocks so an
        # interrupted run resumes from the last completed group
        from fm_radio.utils.checkpoint import save_state

        n = args.checkpoint_every
        done = 0
        while done < avail_blocks:
            upto = min(done + n, avail_blocks)
            app.process(iq[off + done * block : off + upto * block])
            tmp = f"{args.save_state}.tmp.npz"
            save_state(
                tmp, app.demod.state,
                extra={"block_index": start_block + upto},
            )
            os.replace(tmp, args.save_state)
            done = upto
        app.process(iq[off + done * block : n_in])  # leftover -> pending
        print(
            f"checkpointed every {n} blocks to {args.save_state} "
            f"(final block_index={start_block + done})",
            file=sys.stderr,
        )
    else:
        chunk = 64 * block
        for i0 in range(off, n_in, chunk):
            app.process(iq[i0 : min(i0 + chunk, n_in)])
        if n_in == off:
            app.process(iq[off:n_in])  # empty input: clean empty outputs
        if args.save_state:
            from fm_radio.utils.checkpoint import save_state

            save_state(
                args.save_state,
                app.demod.state,
                extra={"block_index": start_block + avail_blocks},
            )
            print(f"saved stream state to {args.save_state}", file=sys.stderr)

    if args.output_wav:
        audio = app.audio[0]
        fs_out = app.demod.fs_audio
        if args.rate and args.rate != fs_out:
            # Resampled_PCM_Player parity (resampled_pcm_player.cpp:37-54):
            # the reference plays at 48 kHz via linear interpolation
            import numpy as _np

            from fm_radio.ops.resample import linear_resample

            n_out = int(round(audio.shape[0] * args.rate / fs_out))
            audio = _np.asarray(linear_resample(audio, n_out))
            fs_out = int(args.rate)
        write_wav_int16(args.output_wav, audio, fs_out)
        print(f"wrote {args.output_wav} ({audio.shape[0]} frames @{fs_out}Hz)",
              file=info_out)
    if args.play:
        # real-time audio out (PortAudio stack parity, io/player.py):
        # feed the sink per-demod-block buffers exactly as the reference's
        # OnAudioBlock -> pcm_player->ConsumeBuffer wiring does
        # (fm_demod_no_tuner.cpp:171-174)
        from fm_radio.io.player import PCMPlayer, PlayerSinkError

        fs_in = int(app.demod.fs_audio)
        out_rate = int(args.rate) if args.rate else 48_000
        chunk = block // 32  # audio frames per demod block
        audio = app.audio[0]
        player = PCMPlayer(command=args.play, output_rate=out_rate,
                           fmt=args.play_format)
        try:
            for i in range(0, audio.shape[0], chunk):
                player.consume(audio[i : i + chunk], fs_in)
        except PlayerSinkError as e:
            sys.exit(f"--play: {e}")
        rc = player.close()
        if rc != 0:
            sys.exit(f"--play: sink {args.play!r} exited with status {rc} "
                     f"after {player.frames_written} frames")
        print(f"played {player.frames_written} frames @{out_rate}Hz "
              f"to {args.play!r}", file=sys.stderr)
    if args.taps:
        os.makedirs(args.taps, exist_ok=True)
        # re-run last block with taps for inspection
        last = iq[max(n_in - block, 0) : n_in]
        outs = app.demod.process(np.asarray(last)[None, :], include_taps=True)
        for name, arr in outs["taps"].items():
            np.save(os.path.join(args.taps, f"{name}.npy"), np.asarray(arr))
        print(f"dumped {len(outs['taps'])} tap buffers to {args.taps}",
              file=info_out)
    if not args.no_rds:
        db = app.rds_database(0)
        for line in app.rds_log_lines(0):
            print(f"[rds_decoder] {line}", file=sys.stderr)
        print(json.dumps(db.summary()), file=info_out)


def cmd_scrape(args) -> None:
    """WAV + RDS-byte artifacts, format-compatible with fm_demod_scraper.

    ``--stream`` runs the NATIVE runtime pipeline (runtime/fmtpu_runtime.cpp):
    a background-prefetching block reader overlapping disk I/O with device
    compute, and an incremental WAV sink with in-place header updates —
    constant memory for arbitrarily long captures (the default path loads
    the whole file, convenient for short recordings)."""
    from fm_radio.config import DemodConfig
    from fm_radio.io.scraper import FMScraper
    from fm_radio.models.app import App

    block = power_ceil(args.block_size)
    i8 = args.ingest == "i8"
    cfg = DemodConfig()

    if args.stream:
        from fm_radio import runtime as rt

        if args.input in (None, "-"):
            sys.exit("--stream needs a file input (-i)")
        if not rt.available():
            sys.exit("--stream needs the native runtime "
                     "(build runtime/libfmtpu_runtime.so)")
        app = App(block_size=block, cfg=cfg, channels=1, decode_rds=True)
        scraper = FMScraper(args.output, use_native=True)
        reader = rt.NativePcmReader(args.input, block)
        fs_audio = int(app.demod.fs_audio)
        rds_bufs = app.rds_chains[0].rds_bytes  # chain's artifact accumulator
        try:
            while True:
                blk = reader.next_i8() if i8 else reader.next_packed()
                if blk is None:
                    break
                app.process(blk if i8 else blk[None, :])
                for a in app.audio_blocks:
                    scraper.on_audio_data(a[0], fs_audio)
                app.audio_blocks.clear()
                # drain (don't re-concatenate history): the only O(new)
                # per block, truly constant-memory consumption pattern
                if rds_bufs:
                    scraper.on_rds_bytes(np.concatenate(rds_bufs))
                    rds_bufs.clear()
        finally:
            reader.close()
            scraper.close()
        print(f"wrote {scraper.wav_paths[-1] if scraper.wav_paths else 'no audio'}"
              f" and {scraper.rds_path or 'no RDS bytes'} (streamed)")
        return

    iq = _i8_input(args.input) if i8 else _packed_input(args.input)
    app = App(block_size=block, cfg=cfg, channels=1, decode_rds=True)
    scraper = FMScraper(args.output)
    fs_audio = int(app.demod.fs_audio)
    rds_bufs = app.rds_chains[0].rds_bytes
    chunk = 64 * block  # O(chunk) host memory for arbitrarily long captures
    try:
        for i0 in range(0, len(iq), chunk):
            app.process(iq[i0 : min(i0 + chunk, len(iq))])
            for a in app.audio_blocks:
                scraper.on_audio_data(a[0], fs_audio)
            app.audio_blocks.clear()
            if rds_bufs:
                scraper.on_rds_bytes(np.concatenate(rds_bufs))
                rds_bufs.clear()
    finally:
        scraper.close()
    print(f"wrote {scraper.wav_paths[-1] if scraper.wav_paths else 'no audio'}"
          f" and {scraper.rds_path or 'no RDS bytes'}")


def cmd_tune(args) -> None:
    """Tuner parity for recorded captures (``fm_demod_tuner.cpp:136``): the
    reference retunes the RTL-SDR's center frequency (``device.cpp:74-83``);
    with file input the equivalent is tuning WITHIN a wideband capture —
    mix the station at ``-f`` Hz offset to DC (ops/mixer.freq_shift_p,
    stream-continuous phase), low-pass polyphase-decimate the ``-r``-rate
    capture down to the chain's native 1.024 MHz, and demodulate.  Outputs
    match ``scrape`` (WAV + RDS bytes)."""
    import jax
    import jax.numpy as jnp

    from fm_radio.config import DemodConfig
    from fm_radio.models.app import App
    from fm_radio.ops.design import create_fir_lpf
    from fm_radio.ops.fir import polyphase_decimate_p
    from fm_radio.ops.mixer import freq_shift_p

    cfg = DemodConfig()
    fs_bb = cfg.rates.fs_baseband
    rate = int(args.rate)
    if rate % fs_bb != 0:
        sys.exit(f"--rate must be an integer multiple of {fs_bb}")
    m = rate // fs_bb
    f_norm = float(args.freq) / rate
    if abs(f_norm) > 0.5:
        sys.exit("--freq is outside the capture bandwidth")
    block = power_ceil(args.block_size)
    os.makedirs(args.output, exist_ok=True)

    # memmap the capture and convert per chunk: O(chunk) host memory (a
    # wideband tune input is the framework's largest — hours at -r 8 Msps)
    if args.input not in (None, "-"):
        try:
            raw = np.memmap(args.input, dtype=np.uint8, mode="r")
            iq_u8 = raw[: (raw.size // 2) * 2].reshape(-1, 2)
        except (OSError, ValueError):
            iq_u8 = _read_input_u8(args.input)
    else:
        iq_u8 = _read_input_u8(args.input)

    def planes(sl: slice):
        c = np.asarray(iq_u8[sl], dtype=np.float32) - 127.0
        return c[:, 0], c[:, 1]

    app = App(block_size=block, channels=1, decode_rds=True)

    if m > 1:
        from fm_radio.utils.transfer import init_on_device

        taps = jnp.asarray(
            create_fir_lpf(
                args.taps_per_phase * m,
                (1.0 / m) * cfg.downsampling_rolloff_factor,
            )
        )
        nn = int(taps.shape[0])
        # complex64 carried tail, created on device
        tail = init_on_device(
            lambda: jnp.zeros((1, nn - m), jnp.complex64)
        )
    phase = jnp.zeros((1,), jnp.float32)

    if m > 1:
        @jax.jit
        def step(phase, tail, xr, xi):
            phase, yp = freq_shift_p(phase, (xr, xi), f_norm)
            tail, yp = polyphase_decimate_p(taps, tail, yp, m)
            return phase, tail, yp[0], yp[1]
    else:
        @jax.jit
        def step(phase, tail, xr, xi):
            phase, yp = freq_shift_p(phase, (xr, xi), f_norm)
            return phase, tail, yp[0], yp[1]
        tail = ()

    chunk = m * block
    n_in = iq_u8.shape[0]
    n_chunks = n_in // chunk
    # trailing samples past the last full chunk still downconvert (one extra
    # trace at the leftover shape); only a sub-m remainder is dropped
    leftover = ((n_in - n_chunks * chunk) // m) * m
    dropped = n_in - n_chunks * chunk - leftover
    if dropped:
        print(f"dropping {dropped} trailing samples (< one decimation frame)",
              file=sys.stderr)
    spans = [slice(i * chunk, (i + 1) * chunk) for i in range(n_chunks)]
    if leftover:
        spans.append(slice(n_chunks * chunk, n_chunks * chunk + leftover))
    for sl in spans:
        xr, xi = planes(sl)
        phase, tail, yr, yi = step(
            phase, tail, jnp.asarray(xr[None, :]), jnp.asarray(xi[None, :]),
        )
        app.process(
            (np.asarray(yr) + 1j * np.asarray(yi)).astype(np.complex64)[0]
        )

    from fm_radio.io.scraper import FMScraper

    scraper = FMScraper(args.output)
    scraper.on_audio_data(app.audio[0], int(app.demod.fs_audio))
    scraper.on_rds_bytes(app.rds_bytes(0))
    scraper.close()
    db = app.rds_database(0)
    print(json.dumps(db.summary()))
    print(f"wrote {scraper.wav_paths[-1]} and {scraper.rds_path}")


def cmd_rds_decode(args) -> None:
    """Bytes -> group log lines + database (parity with rds_decode.cpp)."""
    from fm_radio.rds.chain import RDSDecodingChain

    if args.input is None or args.input == "-":
        data = np.frombuffer(sys.stdin.buffer.read(), dtype=np.uint8)
    else:
        data = np.fromfile(args.input, dtype=np.uint8)
    chain = RDSDecodingChain(strict_ref=args.strict_ref)
    chain.process(data)
    for line in chain.log_lines:
        print(f"[rds_decoder] {line}", file=sys.stderr)
    db = chain.db
    print(json.dumps({"groups": len(chain.groups), **db.summary()}))


def cmd_bench(args) -> None:
    """Throughput harness (the reference's fm_demod_benchmark, but it
    actually measures)."""
    import jax
    import jax.numpy as jnp

    from fm_radio.config import DemodConfig
    from fm_radio.io.pcm import u8_to_c64
    from fm_radio.models.demod import demod_block, demod_init_state, make_coeffs

    block = power_ceil(args.block_size)
    cfg = DemodConfig()
    coeffs = make_coeffs(cfg)
    channels = args.channels

    if args.input:
        iq = u8_to_c64(_read_input_u8(args.input, max_samples=block * 8))
        n_blocks = max(1, len(iq) // block)
        x = np.broadcast_to(
            iq[: n_blocks * block][None], (channels, n_blocks * block)
        ).copy()
    else:
        rng = np.random.default_rng(0)
        n_blocks = 8
        ph = np.cumsum(rng.standard_normal((channels, block * n_blocks)) * 0.5, -1)
        x = (100.0 * np.exp(1j * ph)).astype(np.complex64)

    from fm_radio.utils.transfer import device_put_complex

    xb = device_put_complex(x.reshape(channels, n_blocks, block).transpose(1, 0, 2))

    @jax.jit
    def run(state, xb):
        def step(st, blk):
            st, outs = demod_block(cfg, coeffs, st, blk)
            return st, (outs["audio"], outs["rds_pred"], outs["rds_valid"])

        return jax.lax.scan(step, state, xb)

    state = demod_init_state(cfg, channels)
    jax.block_until_ready(run(state, xb))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(run(state, xb))
        best = min(best, time.perf_counter() - t0)
    msps = channels * block * n_blocks / best / 1e6
    print(
        json.dumps(
            {
                "channels": channels,
                "block_size": block,
                "seconds": round(best, 4),
                "aggregate_msps": round(msps, 2),
                "per_channel_realtime_x": round(msps * 1e6 / channels / 1.024e6, 2),
            }
        )
    )


def cmd_channelize(args) -> None:
    """Wideband IQ -> per-station pcm files via the polyphase filterbank."""
    import jax.numpy as jnp

    from fm_radio.io.pcm import c64_to_u8
    from fm_radio.parallel.channelizer import (
        channelize_packed,
        channelizer_init_state,
        make_channelizer_taps,
    )
    from fm_radio.utils.transfer import fetch

    m = args.num_channels
    w = _packed_input(args.input)
    n = (len(w) // m) * m

    taps = make_channelizer_taps(m, args.taps_per_phase)
    st = channelizer_init_state(m, args.taps_per_phase)
    # chunked (constant memory; filterbank tail carries exactly)
    chunk = max(1 << 22, m)
    chunk -= chunk % m
    parts = []
    for i0 in range(0, n, chunk):
        st, y = channelize_packed(taps, st, w[i0 : min(i0 + chunk, n)], m)
        parts.append(fetch(y))
    y = np.concatenate(parts, axis=1) if parts else np.zeros((m, 0), np.complex64)
    os.makedirs(args.output, exist_ok=True)
    # ONE common scale across channels: per-channel normalization would
    # blow empty bins' leakage floor up to full-scale u8 noise and destroy
    # relative station levels
    scale = max(float(np.abs(y).max()) / 100.0, 1e-9) if y.size else 1.0
    for ch in range(m):
        path = os.path.join(args.output, f"channel_{ch:02d}.pcm")
        c64_to_u8(y[ch] / scale).tofile(path)
    print(f"wrote {m} channel files to {args.output}")


def _add_awgn(iq: np.ndarray, cnr_db: float, seed: int = 0) -> np.ndarray:
    """Complex AWGN at a chosen carrier-to-noise ratio (dB) relative to the
    mean carrier amplitude — shared by synth and the selftest gates."""
    amp = float(np.mean(np.abs(iq)))
    sigma = amp / np.sqrt(2.0 * 10.0 ** (cnr_db / 10.0))
    rng = np.random.default_rng(seed)
    return iq + sigma * (
        rng.standard_normal(iq.size) + 1j * rng.standard_normal(iq.size)
    ).astype(np.complex64)


def _normalize_wideband(iq: np.ndarray) -> np.ndarray:
    """Scale a multi-station sum to the u8 grid: a fixed /2 clips at >=3
    stations (each has amplitude 100; peaks add)."""
    peak = max(float(np.abs(iq.real).max()), float(np.abs(iq.imag).max()))
    return iq * (120.0 / max(peak, 1e-9))


def _run_channelized(w: np.ndarray, m: int, taps_per_phase: int,
                     select: list[int], app) -> None:
    """Chunked wideband streaming: packed words -> polyphase FFT filterbank
    -> the SELECTED station rows into a channel-batched App.  Constant
    memory for arbitrarily long captures: the filterbank's (K-1)-frame tail
    carries exactly across chunks, the demod state carries in App — outputs
    are identical to one-shot."""
    from fm_radio.parallel.channelizer import (
        channelizer_init_state,
        make_channelizer_taps,
        stream_selected,
    )

    taps = make_channelizer_taps(m, taps_per_phase)
    st = channelizer_init_state(m, taps_per_phase)
    stream_selected(taps, st, w, m, select, app.process,
                    chunk_min=m * app.block_size)


def _channel_powers_db(w: np.ndarray, m: int, taps_per_phase: int,
                       window: int) -> np.ndarray:
    """Per-channel RMS power (dB) over the first ``window`` wide samples of
    a packed wideband capture, via the polyphase FFT filterbank."""
    from fm_radio.parallel.channelizer import (
        channelize_packed,
        channelizer_init_state,
        make_channelizer_taps,
    )

    n = min(len(w), window) // m * m
    taps = make_channelizer_taps(m, taps_per_phase)
    st = channelizer_init_state(m, taps_per_phase)
    _, y = channelize_packed(taps, st, w[:n], m)
    settle = taps_per_phase  # filterbank fill
    p = np.abs(np.asarray(y)[:, settle:]) ** 2
    return 10.0 * np.log10(p.mean(axis=1) + 1e-20)


def _detect_active_channels(powers_db: np.ndarray,
                            threshold_db: float) -> list[int]:
    """Channels whose power clears the median (noise-floor estimate) by
    ``threshold_db`` — FM carriers are constant-envelope and sit far above
    an empty channel's noise."""
    floor = float(np.median(powers_db))
    return [int(k) for k in np.nonzero(powers_db > floor + threshold_db)[0]]


def cmd_scan(args) -> None:
    """Station scanner: find the ACTIVE FM carriers in a wideband capture
    and identify them (pilot lock, RDS PI/name).

    Automates the reference's manual workflow — watch the baseband spectrum
    in the GUI, drag the tuner to each bump (render_fm_demod.cpp:98-126 +
    device retune) — and feeds ``fmtpu stations --select``.  No reference
    analogue as a command.
    """
    from fm_radio.models.app import App

    m = args.num_channels
    block = power_ceil(args.block_size)
    fs_ch = 1_024_000
    window = int(args.seconds * fs_ch) * m
    w = _packed_input(args.input, max_samples=window)

    powers = _channel_powers_db(w, m, args.taps_per_phase, window)
    active = _detect_active_channels(powers, args.threshold_db)
    floor = float(np.median(powers))

    report = []
    if active:
        app = App(block_size=block, channels=len(active), decode_rds=True)
        _run_channelized(w, m, args.taps_per_phase, active, app)
        for i, k in enumerate(active):
            db = app.rds_database(i)
            audio = app.audio[i]
            # pilot presence: stereo L-R energy exists only under pilot lock
            lmr = audio[:, 0] - audio[:, 1]
            offset = (k if k <= m // 2 else k - m) * fs_ch
            report.append({
                "channel": k,
                "offset_hz": offset,
                "power_db": round(float(powers[k]), 1),
                "above_floor_db": round(float(powers[k]) - floor, 1),
                "stereo": bool(np.sqrt((lmr**2).mean()) > 1e-3),
                "pi": f"{db.pi_code:04X}" if db.pi_code else None,
                "ps": db.service_name_str.strip() or None,
            })
    print(json.dumps({
        "channels": m,
        "noise_floor_db": round(floor, 1),
        "active": report,
        "select": ",".join(str(k) for k in active),
    }, indent=1))


def cmd_stations(args) -> None:
    """Wideband IQ -> channelize -> ONE channel-batched demod of every
    station -> per-station WAV + RDS database.

    This is the framework's headline path (no reference analogue: the
    reference tunes one station per process, fm_demod_tuner.cpp:136): the
    polyphase FFT filterbank splits the capture and all M stations ride the
    batch axis of a single demod program.
    """
    from fm_radio.io.wav import write_wav_int16
    from fm_radio.models.app import App

    m = args.num_channels
    block = power_ceil(args.block_size)
    # packed ingest: one f32 word per sample (half the host->device bytes),
    # unpacked on the device by the channelizer; lazy memmap view for files
    w = _packed_input(args.input)

    if args.auto:
        # scanner-driven selection: demodulate only channels carrying a
        # station (power above the noise-floor median by threshold-db)
        window = min(len(w), int(1_024_000 * m))  # ~1 s per channel
        powers = _channel_powers_db(w, m, args.taps_per_phase, window)
        select = _detect_active_channels(powers, args.threshold_db)
        if not select:
            sys.exit("--auto found no active channels")
        print(f"auto-selected channels: {select}", file=sys.stderr)
    else:
        select = (
            sorted(int(s) for s in args.select.split(","))
            if args.select
            else list(range(m))
        )
    app = App(block_size=block, channels=len(select), decode_rds=True,
              rds_backend="native" if args.rds_native else "python")
    _run_channelized(w, m, args.taps_per_phase, select, app)

    os.makedirs(args.output, exist_ok=True)
    summary = []
    for i, k in enumerate(select):
        wav_path = os.path.join(args.output, f"station_{k:02d}.wav")
        write_wav_int16(wav_path, app.audio[i], app.demod.fs_audio)
        db = app.rds_database(i)
        summary.append({"channel": k, "wav": wav_path, **db.summary()})
    print(json.dumps(summary, indent=1))


def cmd_synth(args) -> None:
    """Signal generator: synthesize reference-format ``*.pcm`` captures (the
    reference has no transmitter at all — its users need off-air recordings;
    ``fmtpu synth`` produces a complete stereo+RDS station, or a wideband
    multi-station capture on the channelizer's carrier grid, optionally with
    AWGN at a chosen CNR)."""
    from fm_radio.io.pcm import c64_to_u8
    from fm_radio.io.synth import (
        FMModulator,
        ModulatorConfig,
        make_wideband,
        station_group_schedule,
    )

    n = int(args.seconds * 1_024_000)
    af = ([float(s) for s in args.af.split(",")] if args.af else None)

    def one_station(pi: int, ps: str, left: float, right: float):
        mod = FMModulator(ModulatorConfig())
        groups = station_group_schedule(pi, ps=ps, rt=args.rt, af_mhz=af,
                                        pty=args.pty)
        return mod.generate(n, left_hz=left, right_hz=right,
                            rds_groups=groups)

    if args.stations <= 1:
        iq = one_station(int(args.pi, 0), args.ps, args.left_hz,
                         args.right_hz)
        rate = 1_024_000
    else:
        m = args.num_channels or power_ceil(args.stations + 2)
        base_pi = int(args.pi, 0)
        station_iq = {
            k + 1: one_station(base_pi + k, f"ST {k + 1:02d}".ljust(8),
                               args.left_hz * (1 + 0.5 * k), args.right_hz)
            for k in range(args.stations)
        }
        iq = _normalize_wideband(make_wideband(station_iq, m))
        rate = 1_024_000 * m

    if args.cnr is not None:
        iq = _add_awgn(iq, args.cnr, args.seed)

    c64_to_u8(iq.astype(np.complex64)).tofile(args.output)
    print(json.dumps({"path": args.output, "samples": int(iq.size),
                      "rate": rate, "stations": max(args.stations, 1)}))


def cmd_monitor(args) -> None:
    from fm_radio.apps.monitor import run_monitor

    args.block = power_ceil(args.block)
    run_monitor(args)


def cmd_selftest(args) -> None:
    """Headless install/accuracy check: synthesize a known stereo+RDS station,
    run the full demod chain on the active backend, and gate on tone recovery,
    stereo separation, and RDS field decode.  This is the framework's
    replacement for the reference's manual validation loop (play a sample
    recording, eye-check the GUI spectra/constellation/database —
    ``README.md:56-60`` + render_rds_database.cpp); here it is one command
    with machine-readable pass/fail."""
    from fm_radio.io.pcm import c64_to_u8
    from fm_radio.io.synth import (
        FMModulator,
        ModulatorConfig,
        station_group_schedule,
    )
    from fm_radio.models.app import App

    pi, ps = 0x1234, "SELFTEST"
    left_hz, right_hz = 1000.0, 3000.0
    block = power_ceil(args.block_size)
    n = max(int(args.seconds * 1_024_000) // block, 8) * block

    if args.stations > 1:
        return _selftest_wideband(args, n, block, pi, left_hz, right_hz)

    mod = FMModulator(ModulatorConfig())
    groups = station_group_schedule(pi, ps=ps, rt="FMTPU SELFTEST")
    iq = mod.generate(n, left_hz=left_hz, right_hz=right_hz, rds_groups=groups)
    if args.cnr is not None:
        iq = _add_awgn(iq, args.cnr)

    # exercise the real user ingest path: u8 quantization + int8 planes
    # (the default of `fmtpu demod`'s --ingest)
    from fm_radio.utils.transfer import split_iq_i8

    u8 = c64_to_u8(iq.astype(np.complex64)).reshape(-1, 2)
    app = App(block_size=block, channels=1)
    t0 = time.time()
    app.process(split_iq_i8(u8)[:, None, :])
    elapsed = time.time() - t0

    audio = app.audio[0]
    fs = app.demod.fs_audio
    settle = int(0.15 * fs)
    left, right = audio[settle:, 0], audio[settle:, 1]

    def tone_ratio_db(x, f0, bw=100.0):
        spec = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
        freqs = np.fft.rfftfreq(len(x), 1 / fs)
        band = (freqs > f0 - bw) & (freqs < f0 + bw)
        return 10 * np.log10(spec[band].sum() / (spec.sum() + 1e-30))

    separation = tone_ratio_db(right, right_hz) - tone_ratio_db(left, right_hz)
    db = app.rds_database(0).summary()
    n_groups = len(app.rds_log_lines(0))

    checks = {
        "left_tone_db": (round(float(tone_ratio_db(left, left_hz)), 1), -3.0),
        "right_tone_db": (round(float(tone_ratio_db(right, right_hz)), 1), -3.0),
        "stereo_separation_db": (round(float(separation), 1), 20.0),
        "rds_groups": (int(n_groups), 5),
    }
    results = {k: {"value": v, "min": lo, "pass": bool(v > lo)}
               for k, (v, lo) in checks.items()}
    results["rds_pi"] = {"value": db["pi_code"], "expect": f"{pi:04X}",
                         "pass": db["pi_code"] == f"{pi:04X}"}
    results["rds_service_name"] = {"value": db["service_name"], "expect": ps,
                                   "pass": db["service_name"] == ps}
    ok = all(r["pass"] for r in results.values())

    import jax

    print(json.dumps({
        "pass": ok,
        "backend": jax.devices()[0].platform,
        "seconds_audio": round(n / 1_024_000, 3),
        "seconds_elapsed": round(elapsed, 3),
        "checks": results,
    }))
    if not ok:
        sys.exit(1)


def _selftest_wideband(args, n: int, block: int, base_pi: int,
                       left_hz: float, right_hz: float) -> None:
    """Wideband leg of ``fmtpu selftest``: K stations on the channelizer
    carrier grid -> polyphase FFT filterbank -> ONE channel-batched demod ->
    per-station PI/PS gates.  Exercises the framework's headline path
    (synth --stations + channelize + stations) end-to-end in-process."""
    import jax

    from fm_radio.io.pcm import c64_to_u8
    from fm_radio.io.synth import (
        FMModulator,
        ModulatorConfig,
        make_wideband,
        station_group_schedule,
    )
    from fm_radio.models.app import App

    k_st = int(args.stations)
    m = power_ceil(k_st + 2)
    station_iq = {}
    for k in range(k_st):
        mod = FMModulator(ModulatorConfig())
        groups = station_group_schedule(base_pi + k,
                                        ps=f"ST {k + 1:02d}".ljust(8))
        station_iq[k + 1] = mod.generate(
            n, left_hz=left_hz * (1 + 0.5 * k), right_hz=right_hz,
            rds_groups=groups)
    iq = _normalize_wideband(make_wideband(station_iq, m))
    if args.cnr is not None:
        iq = _add_awgn(iq, args.cnr)
    u8 = c64_to_u8(iq.astype(np.complex64))

    app = App(block_size=block, channels=k_st)
    w = pack_iq_u8(u8.reshape(-1, 2))
    t0 = time.time()
    _run_channelized(w, m, 16, list(range(1, k_st + 1)), app)
    elapsed = time.time() - t0

    results = {}
    ok = True
    for i in range(k_st):
        db = app.rds_database(i).summary()
        want_pi, want_ps = f"{base_pi + i:04X}", f"ST {i + 1:02d}".ljust(8)
        st_ok = (db["pi_code"] == want_pi
                 and db["service_name"] == want_ps
                 and len(app.rds_log_lines(i)) >= 5)
        results[f"station_{i + 1}"] = {
            "pi": db["pi_code"], "expect_pi": want_pi,
            "service_name": db["service_name"], "pass": st_ok,
        }
        ok = ok and st_ok

    print(json.dumps({
        "pass": ok,
        "backend": jax.devices()[0].platform,
        "mode": f"wideband x{k_st} (m={m})",
        "seconds_audio": round(n / 1_024_000, 3),
        "seconds_elapsed": round(elapsed, 3),
        "checks": results,
    }))
    if not ok:
        sys.exit(1)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fmtpu", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("demod", help="demodulate IQ pcm -> audio + RDS")
    d.add_argument("-i", "--input", default=None, help="input *.pcm (default stdin)")
    d.add_argument("-b", "--block-size", type=int, default=65536)
    d.add_argument("--ingest", choices=("i8", "f32w"), default="i8",
                   help="device ingest format: int8 planes (default, "
                        "2 bytes per sample) or packed f32 words")
    d.add_argument("-o", "--output-wav", default=None)
    d.add_argument("--taps", default=None, help="dump tap-point buffers to dir")
    d.add_argument("--no-rds", action="store_true")
    d.add_argument("--rate", type=int, default=0,
                   help="resample the output WAV to this rate (the reference "
                        "plays at 48000 via Resampled_PCM_Player)")
    d.add_argument("--play", default=None, metavar="CMD",
                   help="real-time audio out: pipe PCM frames to this shell "
                        "command's stdin ('-' = raw PCM to stdout), e.g. "
                        "\"aplay -f FLOAT_LE -r 48000 -c 2\"; rate from "
                        "--rate (default 48000, portaudio_output.cpp:8)")
    d.add_argument("--play-format", choices=["f32", "s16"], default="f32",
                   help="PCM sample format for --play (f32 = PortAudio "
                        "stream-format parity)")
    d.add_argument("--audio-mode", choices=["stereo", "lpr", "lmr"],
                   default="stereo",
                   help="audio mixer mode (GUI combo, broadcast_fm_demod.h:80)")
    d.add_argument("--deemphasis-us", type=int, default=0,
                   help="enable de-emphasis with this time constant in us "
                        "(GUI toggle+slider; 0 = off)")
    d.add_argument("--lpr-cutoff-hz", type=int, default=0,
                   help="L+R low-pass cutoff override (GUI slider)")
    d.add_argument("--lmr-cutoff-hz", type=int, default=0,
                   help="L-R low-pass cutoff override (GUI slider)")
    d.add_argument("--stereo-gain", type=float, default=None,
                   help="L-R mix factor (GUI slider, default 1.0)")
    d.add_argument(
        "--save-state",
        default=None,
        help="checkpoint the carried stream state (.npz) after processing — "
        "resume a stream mid-file with --resume-state (the reference cannot, "
        "SURVEY.md 5.4); audio continues bit-identically, RDS re-syncs",
    )
    d.add_argument("--resume-state", default=None, help="load a stream-state checkpoint")
    d.add_argument("--resume-seek", action="store_true",
                   help="with --resume-state on the SAME input file: skip the "
                        "blocks the checkpoint already covers (crash restart)")
    d.add_argument("--checkpoint-every", type=int, default=0,
                   help="with --save-state: atomically checkpoint every N "
                        "blocks during processing")
    d.add_argument("--strict-ref", action="store_true",
                   help="exact reference RDS behavior: version-B groups print "
                        "Unsupported_Code (rds_decoder.cpp:146-155) instead "
                        "of being decoded (0B/2B/15B superset)")
    d.set_defaults(fn=cmd_demod)

    s = sub.add_parser("scrape", help="IQ pcm -> WAV + RDS bytes artifacts")
    s.add_argument("-i", "--input", default=None)
    s.add_argument("-b", "--block-size", type=int, default=65536)
    s.add_argument("-o", "--output", required=True)
    s.add_argument("--stream", action="store_true",
                   help="native-runtime streaming pipeline: prefetching "
                        "reader + incremental WAV sink, constant memory")
    s.add_argument("--ingest", choices=("i8", "f32w"), default="i8",
                   help="device ingest format: int8 planes (default, "
                        "2 bytes per sample) or packed f32 words")
    s.set_defaults(fn=cmd_scrape)

    t = sub.add_parser(
        "tune",
        help="tune to a station inside a wideband capture (fm_demod_tuner "
             "for recorded files)",
    )
    t.add_argument("-i", "--input", default=None, help="wideband *.pcm (u8 IQ)")
    t.add_argument("-r", "--rate", type=float, default=1_024_000.0,
                   help="capture sample rate in Hz (multiple of 1.024M)")
    t.add_argument("-f", "--freq", type=float, required=True,
                   help="station offset from capture center in Hz")
    t.add_argument("-b", "--block-size", type=int, default=65536)
    t.add_argument("-o", "--output", required=True)
    t.add_argument("--taps-per-phase", type=int, default=16)
    t.set_defaults(fn=cmd_tune)

    r = sub.add_parser("rds-decode", help="RDS bytes -> groups + database")
    r.add_argument("-i", "--input", default=None)
    r.add_argument("--strict-ref", action="store_true",
                   help="exact reference RDS behavior: version-B groups print "
                        "Unsupported_Code (rds_decoder.cpp:146-155) instead "
                        "of being decoded (0B/2B/15B superset)")
    r.set_defaults(fn=cmd_rds_decode)

    b = sub.add_parser("bench", help="throughput benchmark")
    b.add_argument("-i", "--input", default=None)
    b.add_argument("-b", "--block-size", type=int, default=65536)
    b.add_argument("-c", "--channels", type=int, default=64)
    b.set_defaults(fn=cmd_bench)

    c = sub.add_parser("channelize", help="wideband IQ -> station channels")
    c.add_argument("-i", "--input", default=None)
    c.add_argument("-o", "--output", required=True)
    c.add_argument("-m", "--num-channels", type=int, default=16)
    c.add_argument("--taps-per-phase", type=int, default=16)
    c.set_defaults(fn=cmd_channelize)

    st = sub.add_parser(
        "stations",
        help="wideband IQ -> channelize -> batched demod of every station",
    )
    st.add_argument("-i", "--input", default=None)
    st.add_argument("-o", "--output", required=True)
    st.add_argument("-m", "--num-channels", type=int, default=16)
    st.add_argument("-b", "--block-size", type=int, default=65536)
    st.add_argument("--taps-per-phase", type=int, default=16)
    st.add_argument("--rds-native", action="store_true",
                    help="use the C++ runtime for the per-station bit-serial "
                         "RDS loops (serving fast path at high station counts)")
    st.add_argument(
        "--select", default=None, help="comma-separated channel indices to keep"
    )
    st.add_argument("--auto", action="store_true",
                    help="scanner-driven selection: demodulate only channels "
                         "with power above the noise floor (see `fmtpu scan`)")
    st.add_argument("--threshold-db", type=float, default=15.0,
                    help="--auto detection threshold above the median "
                         "channel power")
    st.set_defaults(fn=cmd_stations)

    sc = sub.add_parser(
        "scan",
        help="find + identify active FM stations in a wideband capture "
             "(power detect -> demod -> pilot/RDS identify)",
    )
    sc.add_argument("-i", "--input", default=None)
    sc.add_argument("-m", "--num-channels", type=int, default=16)
    sc.add_argument("-b", "--block-size", type=int, default=65536)
    sc.add_argument("--taps-per-phase", type=int, default=16)
    sc.add_argument("--seconds", type=float, default=1.0,
                    help="scan window per channel")
    sc.add_argument("--threshold-db", type=float, default=15.0,
                    help="active threshold above the median channel power")
    sc.set_defaults(fn=cmd_scan)

    sy = sub.add_parser(
        "synth",
        help="signal generator: synthesize a stereo+RDS station (or a "
             "wideband multi-station capture) as reference-format pcm",
    )
    sy.add_argument("-o", "--output", required=True)
    sy.add_argument("--seconds", type=float, default=1.0)
    sy.add_argument("--pi", default="0x1234", help="PI code (hex ok)")
    sy.add_argument("--ps", default="FMTPU   ", help="8-char service name")
    sy.add_argument("--rt", default="", help="RadioText (<=64 chars)")
    sy.add_argument("--af", default=None,
                    help="comma-separated alternative freqs in MHz")
    sy.add_argument("--pty", type=int, default=0)
    sy.add_argument("--left-hz", type=float, default=1000.0)
    sy.add_argument("--right-hz", type=float, default=3000.0)
    sy.add_argument("--cnr", type=float, default=None,
                    help="add AWGN at this carrier-to-noise (dB)")
    sy.add_argument("--seed", type=int, default=0)
    sy.add_argument("--stations", type=int, default=1,
                    help=">1: wideband capture, stations on the carrier grid")
    sy.add_argument("-m", "--num-channels", type=int, default=None,
                    help="wideband oversample factor (default: fits stations)")
    sy.set_defaults(fn=cmd_synth)

    m = sub.add_parser(
        "monitor",
        help="live terminal dashboard (spectra/constellation/RDS/profiler — "
             "the reference GUI's panels, headless)",
    )
    m.add_argument("-i", "--input", default=None, help="pcm file (stdin if -)")
    m.add_argument("-b", "--block", type=int, default=65536)
    m.add_argument("--refresh", type=int, default=4,
                   help="blocks per dashboard repaint")
    m.add_argument("--frames", type=int, default=None,
                   help="stop after N repaints (default: until EOF)")
    m.add_argument("--mode", default="average",
                   choices=["normal", "average", "max_hold"],
                   help="spectrum display mode (calculate_fft_mag.h:9-10)")
    m.add_argument("--width", type=int, default=64)
    m.add_argument("--no-ansi", action="store_true",
                   help="plain text frames, no cursor control")
    m.add_argument("--rds-backend", default="python",
                   choices=["python", "native"])
    m.add_argument("--wideband", type=int, default=0, metavar="M",
                   help="treat the input as an M-channel wideband capture "
                        "(M x 1.024 MHz): filterbank-extract one station; "
                        "n/N keys retune live (DeviceSelector parity)")
    m.add_argument("--channel", type=int, default=0,
                   help="initial station channel with --wideband")
    m.add_argument("--play", default=None, metavar="CMD",
                   help="LIVE audio out while monitoring: pipe PCM to this "
                        "shell command ('-' = stdout is the dashboard, so a "
                        "command is required here)")
    m.add_argument("--play-format", choices=["f32", "s16"], default="f32")
    m.set_defaults(fn=cmd_monitor)

    sf = sub.add_parser(
        "selftest",
        help="synthesize a known station, demod it, gate accuracy (one-line "
             "JSON verdict; exit 1 on failure)")
    sf.add_argument("--seconds", type=float, default=2.0)
    sf.add_argument("-b", "--block-size", type=int, default=65536)
    sf.add_argument("--cnr", type=float, default=None,
                    help="optionally add AWGN at this carrier-to-noise dB")
    sf.add_argument("--stations", type=int, default=1,
                    help=">1: wideband mode — K stations through the "
                         "channelize->batched-demod pipeline")
    sf.set_defaults(fn=cmd_selftest)
    return p


def main(argv=None) -> None:
    from fm_radio.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
