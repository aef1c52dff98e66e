"""Offline tap-point plotting — the GUI replacement (SURVEY.md §2.8).

The reference exposes every internal signal in an ImGui/ImPlot window; here
the same tap points (``demod_block(..., include_taps=True)`` /
``fmtpu demod --taps``) render to PNG files.

Usage:
    python tools/plot_taps.py <taps_dir_or_pcm> [out_dir]

If given a .pcm file, demodulates one block first (CPU) and plots its taps;
if given a directory of .npy dumps, plots those.
"""

from __future__ import annotations

import os
import sys

import numpy as np


def _load_taps(path: str, block: int = 65536) -> dict:
    if os.path.isdir(path):
        return {
            f[:-4]: np.load(os.path.join(path, f))
            for f in sorted(os.listdir(path))
            if f.endswith(".npy")
        }
    from fm_radio.io.pcm import iter_pcm_blocks
    from fm_radio.models.demod import BroadcastFMDemod

    d = BroadcastFMDemod(channels=1)
    outs = None
    for blk in iter_pcm_blocks(path, block, max_blocks=4):
        outs = d.process(blk[None], include_taps=True)
    assert outs is not None, "no full blocks in input"
    taps = {k: np.asarray(v) for k, v in outs["taps"].items() if v is not None}
    taps["audio"] = np.asarray(outs["audio"])
    return taps


def main() -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    src = sys.argv[1]
    out_dir = sys.argv[2] if len(sys.argv) > 2 else "tap_plots"
    os.makedirs(out_dir, exist_ok=True)
    taps = _load_taps(src)

    for name, arr in taps.items():
        arr = np.asarray(arr)
        if arr.ndim > 1:
            arr = arr[0]  # channel 0
        fig, axes = plt.subplots(1, 2 if np.iscomplexobj(arr) else 1, figsize=(12, 4))
        axes = np.atleast_1d(axes)
        if np.iscomplexobj(arr):
            axes[0].plot(arr.real[:4096], lw=0.5, label="I")
            axes[0].plot(arr.imag[:4096], lw=0.5, label="Q")
            axes[0].legend()
            spec = 20 * np.log10(
                np.abs(np.fft.fftshift(np.fft.fft(arr[: 1 << 12]))) + 1e-12
            )
            axes[1].plot(spec, lw=0.5)
            axes[1].set_title("magnitude spectrum (dB)")
        else:
            axes[0].plot(arr.reshape(arr.shape[0], -1)[:, 0][:4096] if arr.ndim > 1 else arr[:4096], lw=0.5)
        axes[0].set_title(name)
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"{name}.png"), dpi=100)
        plt.close(fig)
    print(f"wrote {len(taps)} plots to {out_dir}")


if __name__ == "__main__":
    main()
