"""The batched channelizer in plain PyTorch: every channel the radix-2
``fft_int`` of the frozen reference (``reference/int_model.py``) along its
n samples, natural order in and out, as ``benchmark/plain/pair.py`` writes
it in torch operations.  It runs on any device, in blocks of channels, so
that the benchmark's check computes it on the card.

A configuration is any object with the frozen ``FFTConfig``'s fields
``n``, ``mode``, ``rounding``, ``data_width``, ``twiddle_width`` and
``twiddle_gen``; the control is the same transform under another
configuration (``rounding="truncate"``).
"""

from __future__ import annotations

import torch

from benchmark.plain.pair import fft_int

#: the layouts: "cn" is [channels, n] (a channel's samples contiguous),
#: "nc" is [n, channels] (a time step holds every channel)
LAYOUTS = ("cn", "nc")


def channelize(x_re, x_im, cfg, layout: str, block: int = 256):
    """The n-point forward transform of ``cfg`` on every channel of x_re,
    x_im (integer tensors [C, n] for ``layout="cn"``, [n, C] for ``"nc"``,
    on any device): int64 (y_re, y_im) of the same shape and layout,
    computed ``block`` channels at a time on the input's device."""
    if layout not in LAYOUTS:
        raise ValueError(f"bad layout {layout!r}")
    axis = -1 if layout == "cn" else 0
    if x_re.dim() != 2 or x_re.shape[axis] != cfg.n:
        raise ValueError(f"expected {cfg.n} samples a channel in layout "
                         f"{layout!r}, got {tuple(x_re.shape)}")
    if layout == "nc":
        x_re, x_im = x_re.t(), x_im.t()
    outs = [fft_int(*(x[i:i + block].to(torch.int64) for x in (x_re, x_im)),
                    cfg, cfg.n, cfg.data_width)
            for i in range(0, x_re.shape[0], block)]
    y = [torch.cat([o[k] for o in outs]) for k in (0, 1)]
    return tuple(v.t() if layout == "nc" else v for v in y)
