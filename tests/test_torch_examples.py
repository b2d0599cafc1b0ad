"""The port's examples (intfftk_tpu_torch/examples) and entry points
(intfftk_tpu_torch/entry.py) on the CPU at small sizes: each asserts its
own bits against golden, as the JAX examples do."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from intfftk_tpu_torch.entry import entry
from intfftk_tpu_torch.examples import fft_ifft_pair, fft_single
from intfftk_tpu_torch.golden import fft_int

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("n,width", [(64, 16), (256, 12), (1024, 16)])
def test_fft_single(tmp_path, capsys, n, width):
    fft_single.main(n, width, device="cpu", dat_path=str(tmp_path / "d.dat"))
    out = capsys.readouterr().out
    assert out.count("[device bits == golden bits]") == 3
    assert (tmp_path / "d.dat").exists()


@pytest.mark.parametrize("n", [64, 256, 1024])
def test_fft_ifft_pair(capsys, n):
    fft_ifft_pair.main(n, device="cpu")
    assert "OK" in capsys.readouterr().out


def test_examples_command_line(tmp_path):
    """The examples as modules on the command line, on the CPU."""
    for args in (["fft_single", "64", "--device", "cpu", "--dat",
                  str(tmp_path / "d.dat")], ["fft_ifft_pair", "64",
                                              "--device", "cpu"]):
        res = subprocess.run(
            [sys.executable, "-m", f"intfftk_tpu_torch.examples.{args[0]}",
             *args[1:]], cwd=ROOT, capture_output=True, text=True,
            timeout=300)
        assert res.returncode == 0, res.stderr


def test_examples_need_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fft_ifft_pair.main(64)


def test_entry():
    """entry(): the 1024-point scaled/round step on a [1024, 256] tile."""
    plan, (xr, xi) = entry(device="cpu")
    assert tuple(xr.shape) == (1024, 256) and xr.dtype == torch.int32
    yr, yi = plan(xr, xi)
    gr, gi = fft_int(xr.numpy().T, xi.numpy().T, plan.cfg)
    np.testing.assert_array_equal(yr.numpy(), gr.T)
    np.testing.assert_array_equal(yi.numpy(), gi.T)


def test_package_exports():
    """Every name in the port's __all__ imports."""
    import intfftk_tpu_torch as pkg
    import intfftk_tpu_torch.parallel as par
    for mod in (pkg, par):
        for name in mod.__all__:
            assert getattr(mod, name) is not None, name
    for name in ("FourStepPlan", "make_mesh", "pod_mesh", "LargeFFTPlan",
                 "PallasFFTPlan", "FusedAxisFFT", "Channelizer",
                 "OverlapSaveConv", "StreamExecutor", "FFTConfig"):
        assert name in pkg.__all__
