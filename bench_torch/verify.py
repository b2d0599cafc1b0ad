"""Bit checks on the device: every family of ``bench.py``'s
``verify_on_device`` on the port's counterpart plan, each held
``array_equal`` to the port's golden model (``fft_int`` /
``four_step_int`` / ``overlap_save_int``).

On the card the kernels run; on the CPU their plain versions (``--smoke``,
the tests).  The 23 families of ``VERIFY_r05.json`` keep their names; the
later ones are the edges that record left open: the 4M and 16M inverse, a
Taylor stage with twiddles above 16 bits, the int64 path at 1M, the staged
plan at 512K, and the whole four-step (``fuse="whole"``) at the headline
and on the config-2 chain.  ``large`` families (512K and up) are left out
without ``large``, as ``bench.py``'s switch does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import shutil
import sys
import tempfile
from typing import Callable

import numpy as np
import torch

from intfftk_tpu_torch.config import FFTConfig
from intfftk_tpu_torch.golden import (fft_int, four_step_int, make_conv_spec,
                                      overlap_save_int, random_stimulus)
from intfftk_tpu_torch.ops import (FFTPlan, FusedAxisFFT, LargeFFTPlan,
                                   PallasFFTPlan, PallasWideFFTPlan)
from intfftk_tpu_torch.ops.intmath import spectrum_product
from intfftk_tpu_torch.parallel import Channelizer, OverlapSaveConv

from . import cells


@dataclasses.dataclass(frozen=True)
class Family:
    """A bit check: ``run(dev, seed)`` returns (golden arrays, device
    results) of one family; ``seed`` is the family's own (``bench.py``'s)
    unless the caller gives one."""

    name: str
    run: Callable
    seed: int
    large: bool = False


def _t(v, dev):
    return torch.as_tensor(np.asarray(v), device=dev)


def _large(cfg, batch, inverse=False, **kw):
    def run(dev, seed):
        plan = LargeFFTPlan(cfg, inverse=inverse, device=dev, **kw)
        re, im = random_stimulus(cfg.n, 15, seed=seed, batch=(batch,))
        g = four_step_int(re, im, cfg, plan.n1, plan.n2, inverse=inverse)
        return g, plan(_t(re, dev), _t(im, dev))
    return run


def _fused_1k(mode, rnd):
    def run(dev, seed):
        cfg = FFTConfig(n=1024, mode=mode, rounding=rnd, data_width=16,
                        twiddle_width=16)
        if cfg.output_width > 32:
            cfg = dataclasses.replace(cfg, data_width=12)
        re, im = random_stimulus(cfg.n, cfg.data_width - 1, seed=seed,
                                 batch=(128,))
        plan = PallasFFTPlan(cfg, layout="bn", device=dev)
        return fft_int(re, im, cfg), plan(_t(re, dev), _t(im, dev))
    return run


def _multilimb(dev, seed):
    # the JAX kernel's 24 x 25-bit limb tier: here the int64 tile's plan
    cfg = FFTConfig(n=512, mode="scaled", rounding="round", data_width=24,
                    twiddle_width=25)
    re, im = random_stimulus(512, 23, seed=seed, batch=(128,))
    y = PallasWideFFTPlan(cfg, device=dev)(_t(re.T, dev), _t(im.T, dev))
    return fft_int(re, im, cfg), [v.T for v in y]


def _single(plan_cls, n, batch, **cfg_kw):
    def run(dev, seed):
        cfg = FFTConfig(n=n, mode="scaled", rounding="round", **cfg_kw)
        re, im = random_stimulus(n, 15, seed=seed, batch=(batch,))
        return fft_int(re, im, cfg), plan_cls(cfg, device=dev)(
            _t(re, dev), _t(im, dev))
    return run


def _wide_unscaled32(dev, seed):
    cfg = FFTConfig(n=1 << 13, mode="unscaled", data_width=32,
                    twiddle_width=20)
    plan = LargeFFTPlan(cfg, device=dev)
    assert plan.wide1 and plan.wide2
    re, im = random_stimulus(cfg.n, 28, seed=seed, batch=(1,))
    return (four_step_int(re, im, cfg, plan.n1, plan.n2),
            plan(_t(re, dev), _t(im, dev)))


def _raw_chain(dev, seed):
    # fwd raw -> inv raw with the factors swapped == the natural golden
    # composition (int_fft_ifft_pair's no-bitrev trick)
    cfg = cells.config16(1 << 14)
    fwd = LargeFFTPlan(cfg, order="raw", device=dev)
    inv = LargeFFTPlan(cfg, fwd.n2, fwd.n1, inverse=True, order="raw",
                       device=dev)
    re, im = random_stimulus(cfg.n, 15, seed=seed, batch=(2,))
    g = four_step_int(re, im, cfg, fwd.n1, fwd.n2)
    g = four_step_int(*g, cfg, inv.n1, inv.n2, inverse=True)
    return g, inv(*fwd(_t(re, dev), _t(im, dev)))


def _monolithic(dev, seed):
    cfg = cells.config16(1 << 16)
    re, im = random_stimulus(cfg.n, 15, seed=seed, batch=(1,))
    plan = LargeFFTPlan(cfg, schedule="monolithic", device=dev)
    return fft_int(re, im, cfg), plan(_t(re, dev), _t(im, dev))


def _staged(n):
    def run(dev, seed):
        cfg = cells.config16(n)
        re, im = random_stimulus(cfg.n, 15, seed=seed, batch=(1,))
        return fft_int(re, im, cfg), FFTPlan(cfg, device=dev)(
            _t(re, dev), _t(im, dev))
    return run


def _conv(dev, seed):
    spec = make_conv_spec(n=1 << 14, taps_len=(1 << 11) + 1,
                          twiddle_width=16, max_product_width=44,
                          max_spectrum_width=25)
    rng = np.random.default_rng(seed)
    m = spec.taps_len
    h_re = rng.integers(-(1 << 13), 1 << 13, m)
    h_im = rng.integers(-(1 << 13), 1 << 13, m)
    t = spec.payload * 2
    x_re = rng.integers(-(1 << 13), 1 << 13, t)
    x_im = rng.integers(-(1 << 13), 1 << 13, t)
    conv = OverlapSaveConv(spec, h_re, h_im, device=dev)
    return (overlap_save_int(x_re, x_im, h_re, h_im, spec),
            conv(_t(x_re, dev), _t(x_im, dev)))


@contextlib.contextmanager
def _mesh_of_one(dev):
    """A ('ch', 'fft') mesh of this one process: NCCL on the card, gloo on
    the CPU, over a FileStore in a temporary directory; the process group
    is destroyed after, unless it was up before."""
    import torch.distributed as dist
    from intfftk_tpu_torch.parallel import initialize_multihost, pod_mesh

    store = tempfile.mkdtemp()
    up = dist.is_initialized()
    try:
        initialize_multihost(f"file://{store}/store", 1, 0, device=dev)
        yield pod_mesh(1, 1, device=dev)
    finally:
        if dist.is_initialized() and not up:
            dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def _four_step_mesh1(dev, seed):
    from intfftk_tpu_torch.parallel import FourStepPlan

    cfg = FFTConfig(n=1 << 12, mode="scaled", rounding="round")
    re, im = random_stimulus(cfg.n, 15, seed=seed, batch=(2,))
    with _mesh_of_one(dev) as mesh:
        y = [v.cpu() for v in FourStepPlan(cfg, 64, 64, mesh)(re, im)]
    return four_step_int(re, im, cfg, 64, 64), y


def _channelizer_stimulus(seed):
    cfg = FFTConfig(n=4096, mode="scaled", rounding="round")
    re, im = random_stimulus(cfg.n, 15, seed=seed, batch=(256,))
    return cfg, re, im


def _channelizer(layout):
    def run(dev, seed):
        cfg, re, im = _channelizer_stimulus(seed)
        chz = Channelizer(cfg, layout=layout, device=dev)
        if layout == "cn":
            return fft_int(re, im, cfg), chz(chz.shard(re), chz.shard(im))
        y = chz(chz.shard(re.T), chz.shard(im.T))
        return fft_int(re, im, cfg), [v.T for v in y]
    return run


def _channelizer_streamed(dev, seed):
    # bursty chunks -> StreamExecutor -> the nc channelizer, reassembled
    cfg, re, im = _channelizer_stimulus(seed)
    ex = Channelizer(cfg, layout="nc", device=dev).stream(lane_tile=128,
                                                          depth=2)
    rng = np.random.default_rng(seed + 1)
    hr, hi = re.T.copy(), im.T.copy()
    outs, pos = [], 0
    while pos < hr.shape[1]:
        c = min(int(rng.integers(1, 96)), hr.shape[1] - pos)
        outs.extend(ex.feed(hr[:, pos:pos + c], hi[:, pos:pos + c]))
        pos += c
    outs.extend(ex.flush())
    y = [np.concatenate([o[k] for o in outs], axis=1).T for k in (0, 1)]
    return fft_int(re, im, cfg), y


def _whole_c2(dev, seed):
    # the config-2 chain at batch 2 through K1's wide whole form
    run = cells.config2(dev, seed, batch=2)
    return run.reference(), _c2_whole(run, dev)


def _c2_whole(run, dev):
    fwd, inv = run.plans
    wf = LargeFFTPlan(fwd.cfg, fwd.n1, fwd.n2, order="raw", fuse="whole",
                      device=dev)
    wi = LargeFFTPlan(inv.cfg, inv.n1, inv.n2, inverse=True, order="raw",
                      fuse="whole", device=dev)
    hr = torch.full(wf.block_out_shape, 1 << 23, dtype=torch.int32,
                    device=dev)
    y = wf.apply_blocks(*run.x)
    p = spectrum_product(*y, hr, torch.zeros_like(hr), 23,
                         fwd.cfg.output_width, 25, torch.int64)
    return cells.numpy64(wi.apply_blocks(*p), run.x[0].shape[0])


def _c16(log2n):
    return cells.config16(1 << log2n)


#: every family, in order: the 23 of VERIFY_r05.json, then the new edges
FAMILIES = (
    Family("fused_1k_unscaled_truncate", _fused_1k("unscaled", "truncate"),
           1),
    Family("fused_1k_scaled_truncate", _fused_1k("scaled", "truncate"), 1),
    Family("fused_1k_scaled_round", _fused_1k("scaled", "round"), 1),
    Family("fused_multilimb_24x25", _multilimb, 2),
    Family("axis_kernel_2k", _single(FusedAxisFFT, 2048, 64), 3),
    Family("large_64k_scaled", _large(_c16(16), 2), 4),
    Family("large_wide_unscaled32", _wide_unscaled32, 5),
    Family("large_64k_inverse", _large(_c16(16), 2, inverse=True), 6),
    Family("large_raw_chain", _raw_chain, 7),
    Family("monolithic_64k", _monolithic, 8),
    Family("staged_xla_64k", _staged(1 << 16), 8),
    Family("conv_overlap_save_wide", _conv, 9),
    Family("four_step_mesh1", _four_step_mesh1, 10),
    Family("large_512k_split_scaled", _large(_c16(19), 2),
           20 + (1 << 19) % 97, True),
    Family("large_512k_split_inverse", _large(_c16(19), 2, inverse=True),
           20 + (1 << 19) % 97, True),
    Family("large_1m_split_scaled", _large(_c16(20), 1),
           20 + (1 << 20) % 97, True),
    Family("large_1m_split_inverse", _large(_c16(20), 1, inverse=True),
           20 + (1 << 20) % 97, True),
    Family("large_4m_split_scaled", _large(_c16(22), 1), 27, True),
    Family("large_16m_split_scaled", _large(_c16(24), 1), 28, True),
    Family("large_1m_split_wide_unscaled16", _large(
        FFTConfig(n=1 << 20, mode="unscaled", data_width=16,
                  twiddle_width=16), 1), 23, True),
    Family("channelizer_nc_lanes", _channelizer("nc"), 24),
    Family("channelizer_cn", _channelizer("cn"), 24),
    Family("channelizer_streamed", _channelizer_streamed, 24),
    # the edges VERIFY_r05.json left open
    Family("large_4m_split_inverse", _large(_c16(22), 1, inverse=True), 27,
           True),
    Family("large_16m_split_inverse", _large(_c16(24), 1, inverse=True), 28,
           True),
    Family("taylor_4k_tw18", _single(FusedAxisFFT, 4096, 64,
                                     twiddle_width=18), 29),
    Family("large_1m_wide_int64", _large(
        FFTConfig(n=1 << 20, mode="unscaled", data_width=32,
                  twiddle_width=20), 1), 30, True),
    Family("staged_xla_512k", _staged(1 << 19), 31, True),
    Family("whole_64k_scaled", _large(_c16(16), 2, fuse="whole"), 4),
    Family("whole_c2_chain", _whole_c2, 0),
)

#: the family names, in order
NAMES = tuple(f.name for f in FAMILIES)


def _equal(golden, device) -> bool:
    out = []
    for g, d in zip(golden, device):
        if isinstance(d, torch.Tensor):
            d = d.detach().cpu().numpy()
        g, d = np.asarray(g), np.asarray(d)
        out.append(g.shape == d.shape and np.array_equal(
            g.astype(np.int64), d.astype(np.int64)))
    return len(out) == 2 and all(out)


def verify(dev, large: bool = True, seed: int | None = None,
           names=None, log=None) -> list[tuple[str, bool]]:
    """Run every family (without ``large``, none of 512K and up; ``names``:
    only those) on ``dev``: [(name, all arrays equal)].  ``seed`` replaces
    every family's own.  ``log(name, ok)`` is called after each."""
    results = []
    for fam in FAMILIES:
        if (fam.large and not large) or (names and fam.name not in names):
            continue
        golden, device = fam.run(dev, fam.seed if seed is None else seed)
        ok = _equal(golden, device)
        results.append((fam.name, ok))
        if log:
            log(fam.name, ok)
    return results


def log_stderr(name, ok):
    print(f"verify {name}: {'OK' if ok else 'MISMATCH'}", file=sys.stderr,
          flush=True)
