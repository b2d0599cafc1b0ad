"""The CUDA kernel (csrc/fused_pass.cu) against its plain version on the
card.  Marked ``cuda``: each test skips where no CUDA device is present;
on a machine with an H100 run ``python -m pytest tests/test_torch_cuda.py``
(the first test builds the kernel into build/)."""

import dataclasses

import numpy as np
import pytest
import torch

from intfftk_tpu.config import FFTConfig
from intfftk_tpu.golden.four_step import four_step_int
from intfftk_tpu_torch.ops.fused_fft import (LargeFFTPlan, circle_table,
                                              fused_pass,
                                              fused_pass_reference)
from intfftk_tpu_torch.ops.transform import pack_tables

pytestmark = pytest.mark.cuda
MODES = [("unscaled", "truncate"), ("scaled", "truncate"), ("scaled", "round")]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _stimulus(shape, w, seed):
    rng = np.random.default_rng(seed)
    lim = 1 << (w - 1)
    xr = rng.integers(-lim, lim, shape)
    xi = rng.integers(-lim, lim, shape)
    xr[0] = -lim                    # full-scale adversarial first item
    xr[0, ::3] = lim - 1
    return xr, xi


@pytest.mark.parametrize("mode,rounding", MODES)
@pytest.mark.parametrize("r,c,nb", [(8, 40, 3), (64, 40, 3), (256, 256, 4),
                                    (4096, 6, 2)])
@pytest.mark.parametrize("epi", [True, False], ids=["epi_turn", "plain"])
def test_kernel_vs_plain(dev, mode, rounding, r, c, nb, epi):
    """Both pass forms, ragged column tiles, int16 and int32 blocks."""
    cfg = FFTConfig(n=r, mode=mode, rounding=rounding, data_width=16,
                    twiddle_width=16)
    dt = torch.int16 if cfg.output_width <= 16 else torch.int32
    xr, xi = _stimulus((nb, r, c), 16, seed=r + c)
    x = [torch.as_tensor(v).to(dt).to(dev) for v in (xr, xi)]
    tables = tuple(torch.as_tensor(t, device=dev) for t in pack_tables(cfg))
    e = (tuple(torch.as_tensor(t, device=dev) for t in circle_table(
        dataclasses.replace(cfg, n=r * 64), r, c)) if epi else None)
    before = fused_pass.launches
    yr, yi = fused_pass(*x, cfg, tables, epi=e, transpose_out=epi)
    torch.cuda.synchronize()
    assert fused_pass.launches == before + 1
    wr, wi = fused_pass_reference(*x, cfg, tables, epi=e, transpose_out=epi)
    assert torch.equal(yr, wr) and torch.equal(yi, wi)


@pytest.mark.parametrize("mode,rounding,bypass",
                         [m + (False,) for m in MODES]
                         + [("scaled", "truncate", True)])
def test_large_fft_on_card(dev, mode, rounding, bypass):
    cfg = FFTConfig(n=4096, mode=mode, rounding=rounding, bypass_fly=bypass)
    plan = LargeFFTPlan(cfg, 16, 256, device=dev)
    xr, xi = _stimulus((3, 4096), 16, seed=5)
    before = fused_pass.launches
    yr, yi = plan(torch.as_tensor(xr, device=dev),
                  torch.as_tensor(xi, device=dev))
    assert fused_pass.launches == before + 2
    gr, gi = four_step_int(xr, xi, cfg, 16, 256)
    np.testing.assert_array_equal(yr.cpu().numpy(), gr)
    np.testing.assert_array_equal(yi.cpu().numpy(), gi)
