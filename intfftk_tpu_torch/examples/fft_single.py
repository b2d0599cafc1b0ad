"""Single-path FFT walkthrough — the analog of the reference's user flow
``math/fft_single.m`` (stimulus generation + spectrum check) and the
``fft_signle_test.vhd`` testbench (all three numeric modes side by side).

Counterpart of ``examples/fft_single.py``: generates the reference-style
stimulus (tone + noise, quantized to the input width), writes/reads the
``di_single.dat`` file format, runs the natural-order transform in all
three numeric modes through the single-pass plan (one kernel launch on the
card, its plain version with ``--device cpu``), checks every result
bit-for-bit against the golden integer model, and reports SNR vs the
float FFT.

Run:  python -m intfftk_tpu_torch.examples.fft_single [n] [data_width]
          [--device cpu] [--dat PATH]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from ..config import FFTConfig, snr_db
from ..device import resolve
from ..golden import fft_int
from ..ops.single_pass import PallasFFTPlan
from ..utils.dat_io import read_dat, write_dat


def main(n: int = 1024, data_width: int = 16,
         device: torch.device | str | None = None,
         dat_path: str | None = None) -> None:
    device = resolve(device)
    # --- stimulus: near-full-scale tone + noise, the reference's test
    # signal shape (math/fft_single.m:93-98), one bit of headroom
    rng = np.random.default_rng(42)
    t = np.arange(n)
    a = 0.45 * ((1 << (data_width - 1)) - 1)   # half-range amplitude
    bin_k = min(50, n // 4)       # derived from n: valid at any size
    sig = (a * np.exp(2j * np.pi * bin_k * t / n)
           + rng.normal(0, a / 512, n) + 1j * rng.normal(0, a / 512, n))
    x_re = np.round(sig.real).astype(np.int64)
    x_im = np.round(sig.imag).astype(np.int64)

    # --- the reference's .dat interchange format
    path = dat_path or os.path.join(tempfile.gettempdir(), "di_single.dat")
    write_dat(path, x_re, x_im)
    x_re, x_im = read_dat(path)
    print(f"stimulus: n={n}, {data_width}-bit tone+noise -> {path}")
    print(f"device plan: single-pass plan on {device} "
          f"({'CUDA kernel' if device.type == 'cuda' else 'plain version'})")

    batch = [torch.as_tensor(np.broadcast_to(v, (128, n)).copy(),
                             dtype=torch.int32, device=device)
             for v in (x_re, x_im)]
    for mode, rounding in [("unscaled", "truncate"), ("scaled", "truncate"),
                           ("scaled", "round")]:
        cfg = FFTConfig(n=n, mode=mode, rounding=rounding,
                        data_width=data_width, twiddle_width=16)
        g_re, g_im = fft_int(x_re, x_im, cfg)
        if cfg.output_width > 32:
            print(f"  {mode}/{rounding}: output {cfg.output_width} b > 32 "
                  f"-> golden host path only")
        else:
            plan = PallasFFTPlan(cfg, layout="bn", device=device)
            d_re, d_im = (v[0].cpu().numpy() for v in plan(*batch))
            assert np.array_equal(g_re, d_re) and np.array_equal(g_im, d_im), \
                "device bits != golden bits"
        y = g_re + 1j * g_im
        scale = 1.0 if mode == "unscaled" else 1.0 / n
        ref = np.fft.fft(x_re + 1j * x_im) * scale
        print(f"  {mode:8s}/{rounding:8s}: output width "
              f"{cfg.output_width:2d} b, SNR {snr_db(ref, y):5.1f} dB "
              f"vs float FFT  [device bits == golden bits]")

    peak = int(np.argmax(np.abs(y)))
    print(f"spectrum peak at bin {peak} (expected {bin_k})")
    assert peak == bin_k


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=1024)
    ap.add_argument("data_width", type=int, nargs="?", default=16)
    ap.add_argument("--device", default=None,
                    help='"cpu" for the plain version (default: the card)')
    ap.add_argument("--dat", default=None,
                    help="the .dat file (default: di_single.dat in the "
                         "temporary directory)")
    args = ap.parse_args()
    main(args.n, args.data_width, args.device, args.dat)
