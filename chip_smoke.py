#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's paths on one NVIDIA H100.

Run from the root of a checkout, on a machine with an sm_90 card and the
CUDA toolkit (nvcc):

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:

1. toolchain: torch, CUDA and nvcc versions, the card's name and power
   limit, then the kernel is built from csrc/ (printing build seconds and
   the register/shared-memory report of ptxas);
2. the kernel against its plain PyTorch version on the card (torch.equal),
   random and full-scale adversarial stimuli: the forward natural pass
   forms at the 64k path's [64, 256, 256] int16 shapes, ragged column
   tails and a batch of 3; the inverse (natural and raw) and forward raw
   four-step passes at [64, 256, 256]; a transposed load; PallasFFTPlan
   nb/bn x fwd/inv x natural/bitrev at n = 8, 1024, 4096 with ragged
   batches 3 and 200; int32 unscaled/truncate at n = 1024;
3. the 64k forward path: LargeFFTPlan(64k, scaled/round, 16-bit data and
   twiddles).apply_blocks on [64, 256, 256] int16 blocks, bit-equal to
   golden four_step_int for all 64 items, with exactly 2 kernel launches;
   then unscaled/truncate and scaled/truncate at batch 2 and the tone SNR;
4. the Channelizer at its published size, 4096 channels x n = 4096,
   scaled/round, int32 on the card, "cn" and "nc", forward and inverse:
   exactly one launch per call, every channel equal to the plain version
   on the card, 256 channels bit-equal to golden fft_int on the host;
5. the streamed Channelizer: bursty chunks of 64-255 channels,
   lane_tile 512, depth 4, both layouts, bit-equal to the batched result,
   with the stats split;
6. the 64k raw-chained roundtrip at batch 8: LargeFFTPlan(order="raw")
   then the swapped-factor raw inverse, exactly 4 launches, both halves
   bit-equal to four_step_int, and the roundtrip SNR;
7. timing with CUDA events over chained calls, kernel and plain version in
   turns (plain, kernel, kernel, plain);
8. a JSON line describing each ported kernel, then the result line
   {"ok": true, "device": {...}} as the last line.
"""

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N, BATCH, CHAIN = 65536, 64, 50
CH, CH_N, CH_CHAIN, PLAIN_CHAIN = 4096, 4096, 20, 3
RT_BATCH = 8


class SmokeFailure(Exception):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)
    print(f"ok: {what}", flush=True)


def _stimulus(batch, n, seed, adversarial=True, w=16):
    """Random w-bit data; with ``adversarial`` item 0 is the full-scale
    pattern that drives the round-mode difference to +2^(w-1)
    (tests/test_pallas.py::_adversarial) and the last item's imaginary
    part is the most-negative value throughout."""
    rng = np.random.default_rng(seed)
    lim = 1 << (w - 1)
    xr = rng.integers(-lim, lim, (batch, n))
    xi = rng.integers(-lim, lim, (batch, n))
    if adversarial:
        xr[0] = -lim
        xr[0, ::3] = lim - 1
        xi[-1] = -lim
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


def _turns(kernel, plain, xr, xi, calls, plain_calls):
    """Kernel and plain version in turns (plain, kernel, kernel, plain):
    the two mean times and the per-turn times."""
    ms = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = kernel if name == "kernel" else plain
        n = calls if name == "kernel" else plain_calls
        ms[name].append(_event_ms(fn, xr, xi, calls=n,
                                  warmup=3 if name == "kernel" else 1))
    return sum(ms["kernel"]) / 2, sum(ms["plain"]) / 2, ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from intfftk_tpu.config import FFTConfig, snr_db
    from intfftk_tpu.golden import fft_int
    from intfftk_tpu.golden.four_step import four_step_int
    from intfftk_tpu_torch.ops import _build
    from intfftk_tpu_torch.ops.fused_fft import (LargeFFTPlan,
                                                  circle_table, fused_pass,
                                                  fused_pass_reference)
    from intfftk_tpu_torch.ops.single_pass import PallasFFTPlan
    from intfftk_tpu_torch.ops.transform import pack_tables
    from intfftk_tpu_torch.parallel import Channelizer

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
    # largest |kernel - plain| over the comparisons of each ported kernel
    max_err = {"K1": 0, "K2": 0, "K4": 0}

    def same(a, b, what, kernel="K1"):
        err = max(int((x.long() - y.long()).abs().max())
                  for x, y in zip(a, b))
        max_err[kernel] = max(max_err[kernel], err)
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"{what}: kernel == plain")

    def plain_blocks(p, xr, xi):
        kw = dict(inverse=p.inverse, natural=p.order == "natural")
        br, bi = fused_pass_reference(xr, xi, p.cfg1, (p.w1r, p.w1i),
                                      epi=(p.er, p.ei), transpose_out=True,
                                      **kw)
        return fused_pass_reference(br, bi, p.cfg2, (p.w2r, p.w2i),
                                    transpose_out=False, **kw)

    def plain_single(p, xr, xi):
        """The plain version of a single-pass plan's call, on the card."""
        n, shp = p.cfg.n, xr.shape
        turned = not isinstance(p, PallasFFTPlan) or p.layout == "bn"
        view = ((lambda x: x.reshape(1, -1, n)) if turned
                else (lambda x: x.reshape(1, n, -1)))
        yr, yi = fused_pass_reference(
            view(xr), view(xi), p.cfg, (p.w_re, p.w_im), inverse=p.inverse,
            natural=p.order == "natural", transpose_in=turned,
            transpose_out=turned)
        return yr.reshape(shp), yi.reshape(shp)

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

    # the inverse and raw-order four-step forms, pass by pass, at 64k
    forms = {"inverse natural": LargeFFTPlan(cfg, inverse=True, device=dev),
             "forward raw": LargeFFTPlan(cfg, order="raw", device=dev),
             "inverse raw": LargeFFTPlan(cfg, 256, 256, inverse=True,
                                         order="raw", device=dev)}
    for name, p in forms.items():
        kw = dict(inverse=p.inverse, natural=p.order == "natural")
        for adv in (False, True):
            x = blocks(p, *_stimulus(BATCH, N, 7, adversarial=adv))
            args = (p.cfg1, (p.w1r, p.w1i))
            one = fused_pass(*x, *args, epi=(p.er, p.ei), transpose_out=True,
                             **kw)
            ref = fused_pass_reference(*x, *args, epi=(p.er, p.ei),
                                       transpose_out=True, **kw)
            same(one, ref, f"{name} pass 1 [64, 256, 256], adversarial "
                 f"{adv}")
            args = (p.cfg2, (p.w2r, p.w2i))
            same(fused_pass(*ref, *args, transpose_out=False, **kw),
                 fused_pass_reference(*ref, *args, transpose_out=False,
                                      **kw),
                 f"{name} pass 2 [64, 256, 256], adversarial {adv}")
    # a transposed load with the epilogue, inverse raw, int16
    p = forms["inverse raw"]
    x = [v.transpose(1, 2).contiguous()
         for v in blocks(p, *_stimulus(BATCH, N, 8))]
    kw = dict(epi=(p.er, p.ei), transpose_out=False, inverse=True,
              natural=False, transpose_in=True)
    same(fused_pass(*x, p.cfg1, (p.w1r, p.w1i), **kw),
         fused_pass_reference(*x, p.cfg1, (p.w1r, p.w1i), **kw),
         "transposed load [64, 256, 256] inverse raw + epilogue", "K2")

    # the single-pass engine in every layout, direction and order
    for n in (8, 1024, 4096):
        c = FFTConfig(n=n, mode="scaled", rounding="round")
        for layout in ("nb", "bn"):
            for inverse in (False, True):
                for order in ("natural", "bitrev"):
                    sp = PallasFFTPlan(c, inverse=inverse, layout=layout,
                                       order=order, device=dev)
                    for b in (3, 200):
                        xr, xi = _stimulus(b, n, n + b)
                        if layout == "nb":
                            xr, xi = xr.T.copy(), xi.T.copy()
                        x = [torch.as_tensor(v, dtype=torch.int32,
                                             device=dev) for v in (xr, xi)]
                        same(sp(*x), plain_single(sp, *x),
                             f"PallasFFTPlan n={n} {layout} inverse="
                             f"{inverse} {order} B={b}", "K4")
    c = FFTConfig(n=1024, mode="unscaled", rounding="truncate")
    for inverse in (False, True):
        sp = PallasFFTPlan(c, inverse=inverse, device=dev)
        x = [torch.as_tensor(v.T.copy(), dtype=torch.int32, device=dev)
             for v in _stimulus(200, 1024, 9)]
        same(sp(*x), plain_single(sp, *x),
             f"PallasFFTPlan n=1024 unscaled/truncate int32 inverse="
             f"{inverse} B=200", "K4")
    torch.cuda.synchronize()

    # ---- 3. the 64k forward path
    xr, xi = _stimulus(BATCH, N, 5)
    x = blocks(plan, xr, xi)
    torch.cuda.synchronize()
    fused_pass.launches = 0
    yr, yi = plan.apply_blocks(*x)
    torch.cuda.synchronize()
    launches_64k = fused_pass.launches
    check(launches_64k == 2,
          f"64k path launched fused_pass {launches_64k} times")
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

    # ---- 4. the Channelizer, 4096 channels x 4096 points
    ccfg = FFTConfig(n=CH_N, mode="scaled", rounding="round")
    hr, hi = _stimulus(CH, CH_N, 12)                    # [channels, n]
    chans, batched = {}, {}
    ch_launches = {"cn": 0, "nc": 0}
    rows = np.arange(0, CH, CH // 256)                  # 256 golden channels
    for layout in ("cn", "nc"):
        for inverse in (False, True):
            chz = Channelizer(ccfg, inverse=inverse, layout=layout,
                              device=dev)
            chans[layout, inverse] = chz
            src = (hr, hi) if layout == "cn" else (hr.T, hi.T)
            xr, xi = chz.shard(src[0]), chz.shard(src[1])
            torch.cuda.synchronize()
            fused_pass.launches = 0
            yr, yi = chz(xr, xi)
            torch.cuda.synchronize()
            launches = fused_pass.launches
            ch_launches[layout] += launches
            what = f"Channelizer {layout} inverse={inverse}"
            check(launches == 1, f"{what}: {launches} launch per call")
            check(tuple(yr.shape) == tuple(xr.shape)
                  and yr.dtype == torch.int32, f"{what}: int32 "
                  f"{tuple(yr.shape)}")
            same((yr, yi), plain_single(chz.plan, xr, xi),
                 f"{what}: all {CH} channels", "K2" if layout == "cn"
                 else "K4")
            gr, gi = fft_int(hr[rows], hi[rows], ccfg, inverse=inverse)
            got = [v.cpu().numpy() for v in (yr, yi)]
            if layout == "nc":
                got = [v.T for v in got]
            check(np.array_equal(got[0][rows], gr)
                  and np.array_equal(got[1][rows], gi),
                  f"{what}: {rows.size} channels bit-equal to fft_int")
            batched[layout, inverse] = (yr, yi)

    # ---- 5. the streamed Channelizer
    stream_stats = {}

    def run_stream(chz, seed):
        ex = chz.stream(lane_tile=512, depth=4)
        srng = np.random.default_rng(seed)
        for _ in ex.feed(ht[:, :512], it[:, :512]):     # warm the path
            pass
        for _ in ex.flush():
            pass
        ex.reset_stats()
        outs, pos = [], 0
        t0 = time.perf_counter()
        while pos < CH:
            c = min(int(srng.integers(64, 256)), CH - pos)
            outs += list(ex.feed(ht[:, pos:pos + c], it[:, pos:pos + c]))
            pos += c
        outs += list(ex.flush())
        wall = time.perf_counter() - t0
        return ex, outs, wall

    # the host stream as a producer holds it: int32 [n, channels] rows
    ht, it = (np.ascontiguousarray(v.T, np.int32) for v in (hr, hi))
    for layout in ("cn", "nc"):
        chz = chans[layout, False]
        ex, outs, wall = run_stream(chz, 13)
        sr = np.concatenate([o[0] for o in outs], axis=1)
        si = np.concatenate([o[1] for o in outs], axis=1)
        br, bi = (v.cpu().numpy() for v in batched[layout, False])
        if layout == "cn":
            br, bi = br.T, bi.T
        check(np.array_equal(sr, br) and np.array_equal(si, bi),
              f"streamed Channelizer {layout}: bit-equal to the batched "
              f"result")
        st = dict(ex.stats, wall_s=wall,
                  msamples_per_s=CH * CH_N / wall / 1e6)
        stream_stats[layout] = st
        print(f"  stream {layout}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in st.items()))

    # ---- 6. the 64k raw-chained roundtrip
    icfg = dataclasses.replace(cfg, data_width=cfg.output_width)
    fwd = forms["forward raw"]
    inv = LargeFFTPlan(icfg, fwd.n2, fwd.n1, inverse=True, order="raw",
                       device=dev)
    check(inv.block_in_shape == fwd.block_out_shape,
          "raw forward output block == swapped raw inverse input block")
    xr, xi = _stimulus(RT_BATCH, N, 14)
    x = blocks(fwd, xr, xi)
    torch.cuda.synchronize()
    fused_pass.launches = 0
    y = fwd.apply_blocks(*x)
    z = inv.apply_blocks(*y)
    torch.cuda.synchronize()
    launches_rt = fused_pass.launches
    check(launches_rt == 4, f"64k roundtrip: {launches_rt} launches")
    gr, gi = four_step_int(xr, xi, cfg, fwd.n1, fwd.n2)
    o = fwd.raw_spectrum_order()
    check(np.array_equal(y[0].reshape(RT_BATCH, N).cpu().numpy(), gr[:, o])
          and np.array_equal(y[1].reshape(RT_BATCH, N).cpu().numpy(),
                             gi[:, o]),
          "roundtrip forward half: bit-equal to four_step_int (raw order)")
    hr2, hi2 = four_step_int(gr, gi, icfg, inv.n1, inv.n2, inverse=True)
    zr = z[0].reshape(RT_BATCH, N).cpu().numpy()
    zi = z[1].reshape(RT_BATCH, N).cpu().numpy()
    check(np.array_equal(zr, hr2) and np.array_equal(zi, hi2),
          "roundtrip inverse half: bit-equal to four_step_int(inverse)")
    # SNRs over the random items (item 0 and the last are adversarial);
    # scaled both ways, the roundtrip is x / n: read against that
    rnd = slice(1, RT_BATCH - 1)
    xc = xr[rnd] + 1j * xi[rnd]
    rt_snr = snr_db(xc / N, zr[rnd] + 1j * zi[rnd])
    print(f"  roundtrip SNR (scaled/round both ways, against x / n): "
          f"{rt_snr:.2f} dB")
    # the unity-gain pair: a scaled forward into an unscaled inverse
    ucfg = dataclasses.replace(cfg, mode="unscaled")
    uinv = LargeFFTPlan(ucfg, fwd.n2, fwd.n1, inverse=True, order="raw",
                        device=dev)
    uz = uinv.apply_blocks(*(v.int() for v in y))
    hu = four_step_int(gr, gi, ucfg, uinv.n1, uinv.n2, inverse=True)
    uzr = uz[0].reshape(RT_BATCH, N).cpu().numpy()
    uzi = uz[1].reshape(RT_BATCH, N).cpu().numpy()
    check(np.array_equal(uzr, hu[0]) and np.array_equal(uzi, hu[1]),
          "unity-gain roundtrip (unscaled 32-bit inverse): bit-equal")
    u_snr = snr_db(xc, uzr[rnd] + 1j * uzi[rnd])
    print(f"  roundtrip SNR (scaled forward, unscaled inverse, against x):"
          f" {u_snr:.2f} dB")
    check(np.isfinite(rt_snr) and np.isfinite(u_snr),
          "roundtrip SNRs finite")

    # ---- 7. timing, kernel and plain in turns
    x = blocks(plan, *_stimulus(BATCH, N, 5))
    k_ms, p_ms, ms = _turns(lambda a, b: plan.apply_blocks(a, b),
                            lambda a, b: plain_blocks(plan, a, b), *x,
                            CHAIN, CHAIN)
    pass1 = _event_ms(lambda a, b: fused_pass(
        a, b, plan.cfg1, (plan.w1r, plan.w1i), epi=(plan.er, plan.ei),
        transpose_out=True), *x)
    pass2 = _event_ms(lambda a, b: fused_pass(
        a, b, plan.cfg2, (plan.w2r, plan.w2i), transpose_out=False), *x)
    samples = BATCH * N
    moved = 2 * 2 * 2 * samples * 2        # 2 passes x (in + out) x re/im
    print(f"timing on {card}, CUDA events, mean of chained calls:")
    print(f"  64k [64, 256, 256] int16 apply_blocks: kernel {k_ms:.4f} "
          f"ms/call ({ms['kernel'][0]:.4f}, {ms['kernel'][1]:.4f}), "
          f"{samples / k_ms / 1e3:.1f} Msamples/s, "
          f"{moved / k_ms / 1e6:.1f} GB/s; pass 1 {pass1:.4f} ms, pass 2 "
          f"{pass2:.4f} ms; plain {p_ms:.4f} ms ({ms['plain'][0]:.4f}, "
          f"{ms['plain'][1]:.4f})")

    def roundtrip(a, b):
        return inv.apply_blocks(*fwd.apply_blocks(a, b))

    def roundtrip_plain(a, b):
        return plain_blocks(inv, *plain_blocks(fwd, a, b))

    x = blocks(fwd, *_stimulus(RT_BATCH, N, 14))
    rt_ms, rt_plain, rms = _turns(roundtrip, roundtrip_plain, *x, CHAIN,
                                  10)
    print(f"  64k raw roundtrip [8, 256, 256] int16 (4 launches): kernel "
          f"{rt_ms:.4f} ms ({rms['kernel'][0]:.4f}, {rms['kernel'][1]:.4f}),"
          f" {2 * RT_BATCH * N / rt_ms / 1e3:.1f} Msamples/s of transforms;"
          f" plain {rt_plain:.4f} ms ({rms['plain'][0]:.4f}, "
          f"{rms['plain'][1]:.4f})")

    ch_ms = {}
    csamples = CH * CH_N
    cbytes = csamples * 2 * 4 * 2          # re/im x int32 x (in + out)
    for (layout, inverse), chz in chans.items():
        src = (hr, hi) if layout == "cn" else (hr.T, hi.T)
        xr, xi = chz.shard(src[0]), chz.shard(src[1])
        km, pm, cms = _turns(chz, lambda a, b, c=chz: plain_single(c.plan,
                                                                   a, b),
                             xr, xi, CH_CHAIN, PLAIN_CHAIN)
        ch_ms[layout, inverse] = (km, pm)
        print(f"  Channelizer {layout} inverse={inverse} [{CH} x {CH_N}] "
              f"int32: kernel {km:.4f} ms ({cms['kernel'][0]:.4f}, "
              f"{cms['kernel'][1]:.4f}), {csamples / km / 1e3:.1f} "
              f"Msamples/s, {cbytes / km / 1e6:.1f} GB/s; plain {pm:.4f} ms"
              f" ({cms['plain'][0]:.4f}, {cms['plain'][1]:.4f})")
    for layout, st in stream_stats.items():
        print(f"  streamed Channelizer {layout} (lane_tile 512, depth 4): "
              f"wall {st['wall_s'] * 1e3:.2f} ms for {CH} channels, "
              f"{st['msamples_per_s']:.1f} Msamples/s")
    check("jax" not in sys.modules, "no JAX module was imported")

    # ---- 8. results
    src = "intfftk_tpu_torch/csrc/fused_pass.cu"
    mean = lambda layout, k=0: sum(ch_ms[layout, inverse][k]
                                   for inverse in (False, True)) / 2
    print(json.dumps({"kernels": [
        {"name": "fused_pass: K1 four-step, forward natural (64k "
                 "apply_blocks)", "route": "cuda", "source": src,
         "replaces": "intfftk_tpu/ops/pallas_fft.py:1255",
         "launches": launches_64k, "max_abs_err": max_err["K1"],
         "ms": k_ms, "plain_ms": p_ms},
        {"name": "fused_pass: K1 four-step, raw forward + raw inverse "
                 "(64k roundtrip)", "route": "cuda", "source": src,
         "replaces": "intfftk_tpu/ops/pallas_fft.py:1255",
         "launches": launches_rt, "max_abs_err": max_err["K1"],
         "ms": rt_ms, "plain_ms": rt_plain},
        {"name": "fused_pass: K2 transposed load and store (Channelizer cn, "
                 "fwd + inv)", "route": "cuda", "source": src,
         "replaces": "intfftk_tpu/ops/pallas_fft.py:965",
         "launches": ch_launches["cn"], "max_abs_err": max_err["K2"],
         "ms": mean("cn"), "plain_ms": mean("cn", 1)},
        {"name": "fused_pass: K4 single pass [n, B] (Channelizer nc, "
                 "fwd + inv)", "route": "cuda", "source": src,
         "replaces": "intfftk_tpu/ops/pallas_fft.py:829",
         "launches": ch_launches["nc"], "max_abs_err": max_err["K4"],
         "ms": mean("nc"), "plain_ms": mean("nc", 1)}]}))
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
