"""FFT -> IFFT pair roundtrip — the analog of the reference's
``int_fft_ifft_pair`` wrapper and ``fft_double_test.vhd`` testbench.

Counterpart of ``examples/fft_ifft_pair.py``: composes a raw
(bit-reversed spectrum) unscaled forward core with a raw scaled inverse
core — NO reorder between them, the ``int_fft_ifft_pair`` trick (DIF
output order == DIT input order) — and checks the roundtrip recovers the
input to within twiddle-quantization noise.  The inverse input is widened
to the forward's output width, mirroring ``int_fft_ifft_pair.vhd:261``.
Per-core FLY knockouts (``bypass_fly`` / USE_FLY,
``int_fftNk.vhd:259-277``) are demonstrated through the pair plan in
``intfftk_tpu_torch.ops.transform.fft_ifft_pair``.  One kernel launch per
core on the card; the plain version with ``--device cpu``.

Run:  python -m intfftk_tpu_torch.examples.fft_ifft_pair [n] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..config import FFTConfig
from ..device import resolve
from ..golden import bitrev_indices, fft_int, random_stimulus
from ..ops.single_pass import PallasFFTPlan


def main(n: int = 1024, device: torch.device | str | None = None) -> None:
    device = resolve(device)
    cfg = FFTConfig(n=n, mode="unscaled", data_width=12, twiddle_width=16)
    icfg = dataclasses.replace(cfg, mode="scaled", rounding="round",
                               data_width=cfg.output_width)
    print(f"pair: {cfg.data_width}-bit unscaled fwd (out "
          f"{cfg.output_width} b) -> widened scaled/round inv, raw "
          f"spectrum order, no reorder between cores, on {device}")

    fwd = PallasFFTPlan(cfg, layout="bn", order="bitrev", device=device)
    inv = PallasFFTPlan(icfg, inverse=True, layout="bn", order="bitrev",
                        device=device)

    re, im = random_stimulus(n, cfg.data_width - 1, seed=7, batch=(128,))
    x = [torch.as_tensor(v, dtype=torch.int32, device=device)
         for v in (re, im)]
    yr, yi = fwd(*x)                           # bit-reversed spectrum
    xr, xi = (v.cpu().numpy() for v in inv(yr, yi))   # natural time out

    err_r = np.max(np.abs(xr.astype(np.int64) - re))
    err_i = np.max(np.abs(xi.astype(np.int64) - im))
    print(f"roundtrip max |error|: re {err_r}, im {err_i} LSB "
          f"(twiddle-quantization floor)")
    assert max(err_r, err_i) < 8

    # the raw spectrum really is the natural spectrum, bit-reversed
    g_re, g_im = fft_int(re, im, cfg)
    rev = bitrev_indices(n)
    assert np.array_equal(g_re[..., rev], yr.cpu().numpy())
    assert np.array_equal(g_im[..., rev], yi.cpu().numpy())
    print("raw spectrum == natural golden spectrum under bit-reversal: OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=1024)
    ap.add_argument("--device", default=None,
                    help='"cpu" for the plain version (default: the card)')
    args = ap.parse_args()
    main(args.n, args.device)
