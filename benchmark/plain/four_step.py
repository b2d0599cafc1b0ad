"""The integer four-step transform in plain PyTorch, in blocks: the
semantics of the frozen reference's ``four_step_int``
(``reference/four_step.py``) bit for bit, natural order in and out, with
each factor the radix-2 ``fft_int`` of ``benchmark/plain/pair.py``.  It
runs on any device and holds no more than ``block`` columns or rows of a
step's int64 temporaries at once, so that the benchmark's check computes
a 2^24-point frame on the card beside the ring.

A configuration is any object with the frozen ``FFTConfig``'s fields
``n``, ``mode``, ``rounding``, ``data_width``, ``twiddle_width`` and
``twiddle_gen``; the control is the same transform under another
configuration (``rounding="truncate"``).
"""

from __future__ import annotations

import torch

from benchmark.plain.pair import cmult, fft_int, output_width, twiddle_shift
from benchmark.reference.twiddle import circle_twiddles_int


def four_step_blocked(x_re, x_im, cfg, n1: int, n2: int, block: int = 256):
    """The forward four-step of ``cfg`` (size n1 * n2) on frames x_re, x_im
    (integer tensors [..., n], natural order, on any device): int64 (y_re,
    y_im) of the same shape, natural order, on the input's device.

    1. the n1-point column transforms of each frame's [n1, n2] view,
       ``block`` columns at a time;
    2. the inter-factor twiddle W_n^(j2 k1) on each column block's
       transform, from the full-circle table, wrapped to the column
       transforms' output width;
    3. the n2-point row transforms over j2 for each k1, ``block`` rows at
       a time, each written turned into the output (X[k2 n1 + k1])."""
    n = n1 * n2
    if cfg.n != n:
        raise ValueError(f"cfg.n = {cfg.n} is not {n1} x {n2}")
    if x_re.shape[-1] != n or x_im.shape != x_re.shape:
        raise ValueError(f"expected frames [..., {n}], got "
                         f"{tuple(x_re.shape)} and {tuple(x_im.shape)}")
    if block < 1:
        raise ValueError(f"block {block} < 1")
    dev = x_re.device
    shp = x_re.shape[:-1]
    w1 = output_width(cfg, n1, cfg.data_width)
    w_re, w_im = (torch.as_tensor(t, dtype=torch.int64, device=dev)
                  for t in circle_twiddles_int(n, cfg.twiddle_width,
                                               cfg.twiddle_gen))
    k1 = torch.arange(n1, device=dev)
    xr, xi = (x.reshape(shp + (n1, n2)) for x in (x_re, x_im))
    # c[..., j2, k1]: the column transforms, twiddled
    c_re = torch.empty(shp + (n2, n1), dtype=torch.int64, device=dev)
    c_im = torch.empty_like(c_re)
    for j0 in range(0, n2, block):
        cols = slice(j0, min(j0 + block, n2))
        a_re, a_im = (x[..., cols].transpose(-1, -2).to(torch.int64)
                      for x in (xr, xi))
        b_re, b_im = fft_int(a_re, a_im, cfg, n1, cfg.data_width)
        m = torch.arange(cols.start, cols.stop, device=dev)[:, None] * k1
        c_re[..., cols, :], c_im[..., cols, :] = cmult(
            b_re, b_im, w_re[m], w_im[m], twiddle_shift(cfg), w1)
    y_re = torch.empty(shp + (n2, n1), dtype=torch.int64, device=dev)
    y_im = torch.empty_like(y_re)
    for k0 in range(0, n1, block):
        rows = slice(k0, min(k0 + block, n1))
        d_re, d_im = fft_int(c_re[..., rows].transpose(-1, -2),
                             c_im[..., rows].transpose(-1, -2), cfg, n2, w1)
        y_re[..., rows] = d_re.transpose(-1, -2)
        y_im[..., rows] = d_im.transpose(-1, -2)
    return y_re.reshape(shp + (n,)), y_im.reshape(shp + (n,))
