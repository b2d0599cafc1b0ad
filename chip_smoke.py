#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's main path on one NVIDIA H100.

Run from the root of a checkout, on a machine with an sm_90 card and the
CUDA toolkit (nvcc):

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:

1. toolchain: torch, CUDA and nvcc versions, the card's name and power
   limit, then the kernel is built from csrc/ (printing build seconds and
   the register/shared-memory report of ptxas);
2. the kernel against its plain PyTorch version on the card (torch.equal):
   both pass forms at the main path's [64, 256, 256] int16 shapes, random
   and full-scale adversarial stimuli, plus ragged column tails and a
   batch of 3;
3. the main path: LargeFFTPlan(64k, scaled/round, 16-bit data and
   twiddles).apply_blocks on [64, 256, 256] int16 blocks, bit-equal to
   golden four_step_int for all 64 items, with exactly 2 kernel launches;
   then unscaled/truncate and scaled/truncate at batch 2 (int32 blocks,
   64-bit products) and the tone SNR;
4. timing with CUDA events over chained calls: apply_blocks through the
   kernel and through the plain version, in turns;
5. a JSON line describing the kernel, then the result line
   {"ok": true, "device": {...}} as the last line.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N, BATCH, CHAIN = 65536, 64, 50


class SmokeFailure(Exception):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)
    print(f"ok: {what}", flush=True)


def _stimulus(batch, n, seed, adversarial=True, w=16):
    """Random w-bit data; with ``adversarial`` item 0 is the full-scale
    pattern that drives the round-mode difference to +2^(w-1)
    (tests/test_pallas.py::_adversarial)."""
    rng = np.random.default_rng(seed)
    lim = 1 << (w - 1)
    xr = rng.integers(-lim, lim, (batch, n))
    xi = rng.integers(-lim, lim, (batch, n))
    if adversarial:
        xr[0] = -lim
        xr[0, ::3] = lim - 1
    return xr, xi


def _card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _event_ms(fn, xr, xi, calls=CHAIN, warmup=3):
    """Mean device time of one call of a chained xr, xi -> fn(xr, xi)."""
    import torch

    for _ in range(warmup):
        xr, xi = fn(xr, xi)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        xr, xi = fn(xr, xi)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from intfftk_tpu.config import FFTConfig, snr_db
    from intfftk_tpu.golden.four_step import four_step_int
    from intfftk_tpu_torch.ops import _build
    from intfftk_tpu_torch.ops.fused_fft import (LargeFFTPlan,
                                                  circle_table, fused_pass,
                                                  fused_pass_reference)
    from intfftk_tpu_torch.ops.transform import pack_tables

    # ---- 1. toolchain and build
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout
    print(nvcc.strip().splitlines()[-1])
    card = _card_line()
    print(card, flush=True)
    cap = torch.cuda.get_device_capability(dev)
    check(torch.cuda.device_count() >= 1 and cap == (9, 0),
          f"{torch.cuda.get_device_name(dev)} is sm_{cap[0]}{cap[1]}")
    t0 = time.perf_counter()
    so, log = _build.build()
    _build.library()
    print(f"kernel library built in {time.perf_counter() - t0:.2f} s: "
          f"{so.relative_to(ROOT)}")
    for line in log.splitlines():
        if "registers" in line or "bytes stack" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- 2. kernel against its plain version on the card
    cfg = FFTConfig(n=N, mode="scaled", rounding="round", data_width=16,
                    twiddle_width=16)
    plan = LargeFFTPlan(cfg, device=dev)
    check((plan.n1, plan.n2, plan.io16) == (256, 256, True),
          "64k plan: 256 x 256 factors, int16 blocks")
    max_err = 0

    def same(a, b, what):
        nonlocal max_err
        err = max(int((x.long() - y.long()).abs().max())
                  for x, y in zip(a, b))
        max_err = max(max_err, err)
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"{what}: kernel == plain")

    def plain_blocks(p, xr, xi):
        br, bi = fused_pass_reference(xr, xi, p.cfg1, (p.w1r, p.w1i),
                                      epi=(p.er, p.ei), transpose_out=True)
        return fused_pass_reference(br, bi, p.cfg2, (p.w2r, p.w2i),
                                    transpose_out=False)

    def blocks(p, xr, xi):
        shape = (xr.shape[0],) + p.block_in_shape
        return [torch.as_tensor(x).to(p.io_dtype).reshape(shape).to(dev)
                for x in (xr, xi)]

    for adv, what in ((False, "random"), (True, "random + adversarial")):
        x = blocks(plan, *_stimulus(BATCH, N, 1, adversarial=adv))
        one = fused_pass(*x, plan.cfg1, (plan.w1r, plan.w1i),
                         epi=(plan.er, plan.ei), transpose_out=True)
        ref = fused_pass_reference(*x, plan.cfg1, (plan.w1r, plan.w1i),
                                   epi=(plan.er, plan.ei), transpose_out=True)
        same(one, ref, f"pass 1 (epilogue, turned) [64, 256, 256], {what}")
        two = fused_pass(*ref, plan.cfg2, (plan.w2r, plan.w2i),
                         transpose_out=False)
        same(two, fused_pass_reference(*ref, plan.cfg2, (plan.w2r, plan.w2i),
                                       transpose_out=False),
             f"pass 2 (plain) [64, 256, 256], {what}")
    for mode, rnd in (("unscaled", "truncate"), ("scaled", "round")):
        small = LargeFFTPlan(FFTConfig(n=4096, mode=mode, rounding=rnd),
                             16, 256, device=dev)
        x = blocks(small, *_stimulus(3, 4096, 3))
        same(small.apply_blocks(*x), plain_blocks(small, *x),
             f"n=4096 16x256 {mode}/{rnd} batch 3 (C=16 < 32-column tile)")
    c64 = FFTConfig(n=64, mode="unscaled", data_width=16)
    tables = [torch.as_tensor(t, device=dev) for t in pack_tables(c64)]
    epi = [torch.as_tensor(t, device=dev) for t in circle_table(
        FFTConfig(n=4096), 64, 40)]
    x = [torch.as_tensor(v.reshape(3, 64, 40)).int().to(dev)
         for v in _stimulus(3, 64 * 40, 4)]
    same(fused_pass(*x, c64, tables, epi=epi, transpose_out=True),
         fused_pass_reference(*x, c64, tables, epi=epi, transpose_out=True),
         "[3, 64, 40] unscaled int32, 40 % 32 != 0")
    torch.cuda.synchronize()

    # ---- 3. the main path
    xr, xi = _stimulus(BATCH, N, 5)
    x = blocks(plan, xr, xi)
    torch.cuda.synchronize()
    fused_pass.launches = 0
    yr, yi = plan.apply_blocks(*x)
    torch.cuda.synchronize()
    launches = fused_pass.launches
    check(launches == 2, f"main path launched fused_pass {launches} times")
    gr, gi = four_step_int(xr, xi, cfg, 256, 256)
    check(tuple(yr.shape) == (BATCH, 256, 256) and yr.dtype == torch.int16,
          "output [64, 256, 256] int16")
    check(np.array_equal(yr.reshape(BATCH, N).cpu().numpy(), gr)
          and np.array_equal(yi.reshape(BATCH, N).cpu().numpy(), gi),
          "64k scaled/round x 64: bit-equal to four_step_int")
    for mode, rnd in (("unscaled", "truncate"), ("scaled", "truncate")):
        c = FFTConfig(n=N, mode=mode, rounding=rnd, data_width=16,
                      twiddle_width=16)
        p = LargeFFTPlan(c, device=dev)
        xr2, xi2 = _stimulus(2, N, 6)
        before = fused_pass.launches
        y = p(*(torch.as_tensor(v, device=dev) for v in (xr2, xi2)))
        g = four_step_int(xr2, xi2, c, 256, 256)
        check(fused_pass.launches == before + 2
              and all(np.array_equal(a.cpu().numpy(), b)
                      for a, b in zip(y, g)),
              f"64k {mode}/{rnd} x 2 ({p.io_dtype}): bit-equal to "
              f"four_step_int")
    t = np.arange(N)
    rng = np.random.default_rng(11)
    tone = (0.9 * ((1 << 15) - 1) * np.exp(2j * np.pi * 1234 * t / N)
            + rng.normal(0, 64, N) + 1j * rng.normal(0, 64, N))
    tr, ti = np.round(tone.real).astype(np.int64)[None], np.round(
        tone.imag).astype(np.int64)[None]
    y = plan(torch.as_tensor(tr, device=dev), torch.as_tensor(ti, device=dev))
    yc = (y[0].long().cpu().numpy()[0] + 1j * y[1].long().cpu().numpy()[0])
    g = four_step_int(tr, ti, cfg, 256, 256)
    snr = snr_db(np.fft.fft(tone.real.round() + 1j * tone.imag.round()) / N,
                 yc)
    check(np.array_equal(yc, g[0][0] + 1j * g[1][0]) and np.isfinite(snr)
          and snr > 40, f"tone SNR {snr:.2f} dB (golden model's bits)")

    # ---- 4. timing, kernel and plain in turns
    kernel = lambda a, b: plan.apply_blocks(a, b)
    plain = lambda a, b: plain_blocks(plan, a, b)
    turns = [("plain", plain), ("kernel", kernel), ("kernel", kernel),
             ("plain", plain)]
    ms = {"plain": [], "kernel": []}
    for name, fn in turns:
        ms[name].append(_event_ms(fn, *x))
    pass1 = _event_ms(lambda a, b: fused_pass(
        a, b, plan.cfg1, (plan.w1r, plan.w1i), epi=(plan.er, plan.ei),
        transpose_out=True), *x)
    pass2 = _event_ms(lambda a, b: fused_pass(
        a, b, plan.cfg2, (plan.w2r, plan.w2i), transpose_out=False), *x)
    k_ms = sum(ms["kernel"]) / 2
    p_ms = sum(ms["plain"]) / 2
    samples = BATCH * N
    moved = 2 * 2 * 2 * samples * 2        # 2 passes x (in + out) x re/im
    print(f"timing on {card}, [64, 256, 256] int16, mean of {CHAIN} "
          f"chained calls:")
    print(f"  kernel apply_blocks: {k_ms:.4f} ms/call "
          f"({ms['kernel'][0]:.4f}, {ms['kernel'][1]:.4f}), "
          f"{samples / k_ms / 1e3:.1f} Msamples/s, "
          f"{moved / k_ms / 1e6:.1f} GB/s")
    print(f"  kernel pass 1: {pass1:.4f} ms, pass 2: {pass2:.4f} ms")
    print(f"  plain apply_blocks:  {p_ms:.4f} ms/call "
          f"({ms['plain'][0]:.4f}, {ms['plain'][1]:.4f}), "
          f"{samples / p_ms / 1e3:.1f} Msamples/s")
    check("jax" not in sys.modules, "no JAX module was imported")

    # ---- 5. results
    print(json.dumps({"kernels": [{
        "name": "fused_pass", "route": "cuda",
        "source": "intfftk_tpu_torch/csrc/fused_pass.cu",
        "replaces": "intfftk_tpu/ops/pallas_fft.py:1255",
        "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
