"""Overflow sanitizer — the framework's race-detector analog (SURVEY §5).

The reference prevents data hazards by construction (single clock domain,
valid strobes); its only numeric hazard is register wrap in unscaled mode
when inputs exceed the headroom contract (docs/numerics.md).  Hardware
wraps silently.  This module *detects* those wraps: each stage is computed
twice in lockstep — once at the true register width and once with an
unbounded (63-bit) container — and every value where the two disagree is a
register overflow introduced at that stage.  The true-width result is
propagated, so the report localizes the FIRST wrap per data path exactly
(the "int64 shadow computation" suggested by the survey); use it in CI and
to qualify production signal levels for unscaled operation.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import FFTConfig
from .float_model import bitrev_indices
from .int_model import dif_butterfly_int, dit_butterfly_int, needs_object

_WIDE = 60  # in_w for the shadow pass: wrap at 61+ bits == never


@dataclasses.dataclass
class OverflowReport:
    """Wrap events per stage (stage -1 = input out of width contract)."""

    stage_wraps: dict
    total: int

    @property
    def clean(self) -> bool:
        return self.total == 0

    def __str__(self):
        if self.clean:
            return "no overflow"
        per = ", ".join(f"stage {s}: {c}" for s, c in
                        sorted(self.stage_wraps.items()))
        return f"{self.total} wrapped values ({per})"


def check_overflow(x_re, x_im, cfg: FFTConfig,
                   inverse: bool = False) -> OverflowReport:
    """Run the transform counting values that wrap their register width."""
    if cfg.output_width + 1 >= _WIDE:
        raise ValueError("config too wide for the int64 shadow pass")
    n, nl = cfg.n, cfg.stages
    dt = object if needs_object(cfg) else np.int64
    xr = np.asarray(x_re, dtype=dt).copy()
    xi = np.asarray(x_im, dtype=dt).copy()
    rev = bitrev_indices(n)
    if inverse:
        xr, xi = xr[..., rev], xi[..., rev]

    wraps: dict = {}
    total = 0
    lim = np.int64(1) << (cfg.data_width - 1)
    bad = int(np.sum(xr >= lim) + np.sum(xr < -lim)
              + np.sum(xi >= lim) + np.sum(xi < -lim))
    if bad:
        wraps[-1] = bad
        total += bad

    bfly = dit_butterfly_int if inverse else dif_butterfly_int
    for s in range(nl):
        p = cfg.stage_twiddle_order(s, inverse)
        h = 1 << p
        in_w = cfg.stage_input_width(s)
        shp = xr.shape[:-1]
        vr = xr.reshape(shp + (-1, 2, h))
        vi = xi.reshape(shp + (-1, 2, h))
        ar, ai = vr[..., 0, :], vi[..., 0, :]
        br, bi = vr[..., 1, :], vi[..., 1, :]
        k = np.arange(h)
        o_true = bfly(ar, ai, br, bi, k, p, cfg, in_w)
        o_wide = bfly(ar, ai, br, bi, k, p, cfg, _WIDE)
        cnt = sum(int(np.sum(t != w)) for t, w in zip(o_true, o_wide))
        if cnt:
            wraps[s] = cnt
            total += cnt
        xr = np.stack([o_true[0], o_true[2]], axis=-2).reshape(shp + (n,))
        xi = np.stack([o_true[1], o_true[3]], axis=-2).reshape(shp + (n,))
    return OverflowReport(stage_wraps=wraps, total=total)
