"""Real multi-process validation of the multi-host demod path (BASELINE config 5).

The single-process tests (tests/test_sharding.py) exercise the 2D ch x t mesh
on 8 virtual devices inside ONE process; this tool runs the SAME program as a
true multi-controller SPMD job — N independent Python processes ("hosts"),
each owning K local CPU devices, joined with ``jax.distributed.initialize``.
Cross-process collectives run over Gloo, standing in for the inter-host
network; the halo ``ppermute`` of ``demod_time_parallel`` crosses the
process boundary exactly as it would cross hosts.  The workers run on the
CPU only: several JAX processes cannot share one GPU.

Default mesh layout: the ``ch`` (channel/DP) axis spans processes (the inter-host-like boundary — zero
steady-state collectives), the ``t`` (time/SP) axis stays within a process's
local devices (the intra-host-like boundary carrying the raw-IQ halo exchange).
With --t-over-hosts the axes swap, forcing the halo ppermute itself across
the process boundary — proving state handoff survives the process boundary too.

Each worker validates its OWN addressable output shards against the exact
sequential single-stream demodulation (``demod_stream``), using the settled
region SNR gate from tests/test_sharding.py.  All workers must print PASS
and exit 0; the launcher aggregates.

Usage (launcher spawns the workers):
    python tools/multihost.py [--nproc 2] [--local-devices 2] [--t-over-hosts]

Reference analogue: none — the reference is a single-process application
(SURVEY.md §2.10); this is a new first-class component of the framework.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

BLOCK = 16384
N_BLOCKS = 16  # total stream length in blocks
WARMUP = 2


def worker(args: argparse.Namespace) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    pid = int(os.environ["FMTPU_MH_PROC"])
    jax.distributed.initialize(
        os.environ["FMTPU_MH_COORD"],
        num_processes=args.nproc,
        process_id=pid,
        cluster_detection_method="deactivate",
    )

    import jax.numpy as jnp
    import numpy as np

    from fm_radio.config import DemodConfig
    from fm_radio.io.synth import FMModulator, ModulatorConfig
    from fm_radio.models.app import demod_stream
    from fm_radio.models.demod import make_coeffs
    from fm_radio.parallel import demod_time_parallel, make_mesh
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_dev = args.nproc * args.local_devices
    assert jax.device_count() == n_dev, (jax.device_count(), n_dev)
    # the settled-SNR gate only compares time shards > 0; without time
    # sharding every shard is the (skipped) cold-start shard and the run
    # would verify nothing
    assert (args.nproc if args.t_over_hosts else args.local_devices) >= 2, (
        "validation requires >= 2 devices along the time axis"
    )
    if args.t_over_hosts:
        # time axis across processes: the halo ppermute crosses processes
        n_ch_mesh, n_t = args.local_devices, args.nproc
        mesh = make_mesh(n_ch_mesh, n_t, devices=np.asarray(
            jax.devices()).reshape(n_t, n_ch_mesh).T.reshape(-1).tolist())
    else:
        # channel axis across processes (the pod-default layout)
        n_ch_mesh, n_t = args.nproc, args.local_devices
        mesh = make_mesh(n_ch_mesh, n_t)

    # deterministic input, identical on every process (multi-controller SPMD
    # requires all processes to agree on global values)
    c = n_ch_mesh  # one channel row per ch-mesh slot keeps shapes tiny
    t_total = BLOCK * N_BLOCKS
    mod = FMModulator(ModulatorConfig())
    iq = mod.generate(t_total, left_hz=1000.0, right_hz=3000.0)
    x_np = np.stack([np.asarray(iq)] * c)  # identical channels

    sharding = NamedSharding(mesh, P("ch", "t"))
    x = jax.make_array_from_callback(
        (c, t_total), sharding, lambda idx: x_np[idx]
    )

    cfg = DemodConfig()
    coeffs = make_coeffs(cfg)
    outs = demod_time_parallel(
        cfg, coeffs, x, mesh, block_size=BLOCK, warmup_blocks=WARMUP,
    )
    audio = outs["audio"]  # [C, T/32, 2] sharded P('ch', 't', None)

    # exact sequential reference (cheap at this scale; every process computes
    # the same full reference and checks only its local shards against it)
    _, outs_seq = demod_stream(cfg, x_np, block_size=BLOCK)
    audio_seq = np.asarray(outs_seq["audio"])  # [C, T/32, 2]

    blk_audio = BLOCK // 32
    shard_blocks = N_BLOCKS // n_t
    checked, exact, min_snr = 0, 0, float("inf")
    for sh in audio.addressable_shards:
        a_par = np.asarray(sh.data)
        c0 = sh.index[0].start or 0
        t0 = sh.index[1].start or 0
        t_shard = t0 // (blk_audio * shard_blocks)  # which time shard
        assert np.isfinite(a_par).all()
        a_ref = audio_seq[c0 : c0 + a_par.shape[0], t0 : t0 + a_par.shape[1]]
        if t_shard == 0:
            # the stream-start shard resets to the true init state at its
            # payload boundary: it computes the sequential stream exactly,
            # modulo one-ULP scheduling noise between the multi-process
            # partitioned compile and the single-process reference compile
            # (measured max 1.5e-7; in-process it is bit-exact —
            # tests/test_sharding.py asserts array_equal there)
            np.testing.assert_allclose(
                a_par, a_ref, atol=1e-5, rtol=0,
                err_msg=f"proc {pid} shard-0 at {sh.index}")
            exact += 1
            continue
        # settled-region gate (tests/test_sharding.py): skip the first
        # payload block after the warm-up halo
        lo = blk_audio
        err = np.sqrt(np.mean((a_par[:, lo:] - a_ref[:, lo:]) ** 2))
        ref = np.sqrt(np.mean(a_ref[:, lo:] ** 2)) + 1e-12
        snr = 20 * np.log10(ref / (err + 1e-12))
        min_snr = min(min_snr, snr)
        checked += 1
        assert snr > 25.0, f"proc {pid} shard at {sh.index}: SNR {snr:.1f} dB"
    # every local shard is gated: later shards by settled SNR, the
    # stream-start shard by exact equality
    assert checked + exact == len(audio.addressable_shards) > 0

    verdict = {
        "proc": pid,
        "pass": True,
        "devices": n_dev,
        "processes": args.nproc,
        "mesh": dict(mesh.shape),
        "t_over_hosts": bool(args.t_over_hosts),
        "shards_checked": checked,
        "shards_exact": exact,
        "min_settled_snr_db": round(float(min_snr), 1) if checked else None,
    }

    if args.bench_reps > 0:
        # throughput of the jitted sharded program on a FIXED global
        # workload (same channels x samples regardless of mesh shape), so
        # nproc=1/2/4 rows are comparable; every process participates (the
        # t-over-hosts layout runs its halo ppermute across processes)
        import time

        c_b = n_ch_mesh * max(1, -(-4 // n_ch_mesh))  # >=4, multiple of mesh
        x_b = jax.make_array_from_callback(
            (c_b, t_total), sharding,
            lambda idx: np.broadcast_to(iq, (c_b, t_total))[idx],
        )
        f = jax.jit(lambda xx: demod_time_parallel(
            cfg, coeffs, xx, mesh, block_size=BLOCK,
            warmup_blocks=WARMUP)["audio"])
        jax.block_until_ready(f(x_b))  # compile
        t0 = time.perf_counter()
        for _ in range(args.bench_reps):
            jax.block_until_ready(f(x_b))
        dt = time.perf_counter() - t0
        verdict["bench"] = {
            "channels": c_b,
            "samples_per_rep": c_b * t_total,
            "reps": args.bench_reps,
            "samples_per_s": round(c_b * t_total * args.bench_reps / dt),
        }

    print(json.dumps(verdict), flush=True)


def _free_port() -> int:
    # pid-salted search narrows the bind-then-release TOCTOU window when
    # several launchers (parallel CI) pick ports at the same time — each
    # starts its scan at a different offset instead of racing for the same
    # ephemeral port
    base = 21000 + os.getpid() % 20000
    for off in range(200):
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", base + off))
            except OSError:
                continue
            return s.getsockname()[1]
    raise RuntimeError("no free coordinator port found")


def launch(args: argparse.Namespace) -> int:
    port = _free_port()

    env = {
        **os.environ,
        # hermetic CPU backend: the workers are several JAX processes, and
        # only one process may hold a GPU (each would reserve most of its
        # memory), so they never open one
        "JAX_PLATFORMS": "cpu",
        "CUDA_VISIBLE_DEVICES": "",
        "XLA_FLAGS": f"--xla_force_host_platform_device_count={args.local_devices}",
        "FMTPU_MH_COORD": f"127.0.0.1:{port}",
        # the worker re-executes THIS file, whose dir is tools/ — put the
        # repo root on the path so fm_radio imports
        "PYTHONPATH": os.pathsep.join(
            [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
            + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])
        ),
    }
    import time

    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *sys.argv[1:]],
            env={**env, "FMTPU_MH_PROC": str(i)},
            stdout=subprocess.PIPE, text=True,
            # own process group: a kill cleans up the worker and anything
            # it spawned even if the launcher itself is later SIGKILLed
            start_new_session=True,
        )
        for i in range(args.nproc)
    ]
    deadline = time.monotonic() + args.timeout  # GLOBAL, not per-worker
    rc, outs = 0, []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(0.1, deadline - time.monotonic()))
            outs.append(out or "")
            rc |= p.returncode
        except subprocess.TimeoutExpired:
            for q in procs:
                try:
                    os.killpg(q.pid, 9)
                except (ProcessLookupError, PermissionError):
                    q.kill()
            print("TIMEOUT: killed workers", file=sys.stderr)
            return 124
    sys.stdout.write("".join(outs))
    # guard against a vacuous pass: at least one worker must have actually
    # compared shards against the sequential reference
    total_checked = sum(
        json.loads(line).get("shards_checked", 0)
        + json.loads(line).get("shards_exact", 0)
        for out in outs
        for line in out.splitlines()
        if line.startswith("{")
    )
    if rc == 0 and total_checked == 0:
        print("FAIL: no worker checked any shard", file=sys.stderr)
        rc = 1
    benches = [
        json.loads(line)["bench"]
        for out in outs
        for line in out.splitlines()
        if line.startswith("{") and "bench" in json.loads(line)
    ]
    if benches:
        # the global step completes when the SLOWEST process does
        agg = min(b["samples_per_s"] for b in benches)
        print(json.dumps({"aggregate_samples_per_s": agg,
                          "nproc": args.nproc,
                          "local_devices": args.local_devices,
                          "t_over_hosts": bool(args.t_over_hosts)}))
    print("MULTIHOST " + ("PASS" if rc == 0 else "FAIL"))
    return rc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--local-devices", type=int, default=2)
    ap.add_argument("--t-over-hosts", action="store_true",
                    help="put the time axis across processes so the halo "
                    "ppermute crosses the host boundary")
    ap.add_argument("--bench-reps", type=int, default=0,
                    help="also time the jitted sharded program (N reps on a "
                    "fixed global workload) and report samples/s")
    ap.add_argument("--timeout", type=float, default=540.0)
    args = ap.parse_args()
    if os.environ.get("FMTPU_MH_PROC") is not None:
        worker(args)
        return 0
    return launch(args)


if __name__ == "__main__":
    sys.exit(main())
