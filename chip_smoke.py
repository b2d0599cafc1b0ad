#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's paths on one NVIDIA H100.

Run from the root of a checkout, on a machine with an sm_90 card and the
CUDA toolkit (nvcc):

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:

1. toolchain: torch, CUDA and nvcc versions, the card's name and power
   limit, then the kernel is built from csrc/ (printing build seconds and
   the register/shared-memory report of ptxas);
2. the kernels against their plain PyTorch versions on the card
   (torch.equal), random and full-scale adversarial stimuli: the forward
   natural pass forms at the 64k path's [64, 256, 256] int16 shapes,
   ragged column tails and a batch of 3; the inverse (natural and raw)
   and forward raw four-step passes at [64, 256, 256]; a transposed load;
   PallasFFTPlan nb/bn x fwd/inv x natural/bitrev at n = 8, 1024, 4096
   with ragged batches 3 and 200; int32 unscaled/truncate at n = 1024;
   the twiddle generator against the host circle table at 512K and 1M
   (fwd/inv, twiddle_gen auto and taylor_new) and 16M (auto); the in-kernel
   synthesis epilogue at [4, 1024, 1024] and the ragged [3, 1024, 40]
   (n = 2^20); the monolithic 2-D stage pass at [64, 256, 256] and
   [2, 1024, 512], both directions;
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
7. the 1M block chain at its published size (bench_large_blocks(1M,
   batch=4)): plan a then the swapped-factor plan b on [4, 1024, 1024]
   int16 blocks, in epi_mode host, device and inkernel, 2 launches per
   plan call, the generator once per device-mode plan, bit-equal to
   four_step_int; the inverse too;
8. 512K on the flat contract (batch 8, 1024 x 512), forward and inverse
   against four_step_int; 16M (4096 x 4096, batch 1) in device and
   inkernel mode, kernel == plain on the card, and against four_step_int
   at 16M when the golden model is estimated under a minute, else at 4M;
9. the monolithic schedule: 64 x 64k and 2 x 512K, forward and inverse,
   bit-equal to fft_int, 2 launches per call; the 64k roundtrip and the
   64k raw order;
10. the wide (> 32-bit) data path on int64 tiles: (a) every wide pass
    form against its plain version (the config-2 passes at [8, 256, 256],
    the widening pass at [64, 256, 256], ragged [3, m, 40] tiles at
    m = 8 to 4096, full-scale 52-bit scaled/round data with 27-bit
    twiddles); (b) the config-2 chain at batch 8 (bench_config2: raw
    unscaled 32-bit forward to 48 bits, the exact-unity 25-bit spectrum
    product through the product kernel, raw scaled/round inverse), exactly
    4 pass launches and 1 product launch, bit-equal to four_step_int both
    ways, and its SNR; (c) the 64k unscaled 24-bit
    plan, whose pass 2 widens to int64, at batch 64: 2 launches, bit-equal
    to four_step_int; (d) PallasWideFFTPlan (K5) on an int64 [4096, 1024]
    tile, fwd/inv x natural/bitrev: 1 launch per call, equal to the plain
    version, 64 columns bit-equal to fft_int;
11. the ceiling probes (csrc/probe.cu, K7-K9): every chain body on int32,
    the int16 add chain and its packed form, and the copy, each equal to
    its plain version (torch.equal) at the shapes the probe tool uses;
    then the tool's own run (tools.probe_vpu.measure_all, one reading of
    each chain) with its two guards, both fatal: time linear in the chain
    length within 5 %, and no chain above SMs x 128 lanes x the maximum SM
    clock x its ops per instruction at full fusion; the copy held below
    the card's memory peak; one line of ceilings with the card's name and
    power limit;
12. overlap-save convolution at its published size (bench_config4: 64k
    blocks, 8193 real taps, 16-bit twiddles, a 44-bit product and a 25-bit
    taps spectrum, seed 1, taps and data in +-2^13) at T = 4 and T = 64
    payloads, built on the card by default (no device argument): exactly
    4 pass launches and 1 product launch per call, bit-equal to golden
    overlap_save_int, kernel == plain on the card, and the SNR against the
    float FFT convolution; the n = 4096 single-pass engine pair at 513
    taps, 2 pass launches and 1 product launch;
13. the spectrum product kernel (csrc/product.cu, P1) against its plain
    version: config 4's form (int32 -> int64, 44 bits) on full-scale
    +-2^31 data, config 2's (int64, 48 bits, a full-scale 25-bit table,
    128-bit product-sums), int32 -> int32, and an element count no vector
    width divides;
14. the factor pass at a batch of 65 536 items (m = 8, 5 columns): one
    call, two launches, both counted, kernel == plain; and every split of
    a factor into stage groups (m = 8, 16, 32, 64: remainders 0, 1, 2 of
    the group size) on 1, 5, 33 and 40 columns, forward and inverse,
    turned load and turned store, int32 and int64, kernel == plain;
15. the per-stage probe (csrc/probe_stages.cu, K10): every step's once and
    loop kernel against its plain version and every variant against the
    production step, on unscaled data and on the scaled/round config that
    is timed: the round-trip stage, and the stage groups the factor pass
    now runs (stage_group of csrc/stage_body.cuh, the function the pass
    calls: three, two or one stage through one exchange of the tile, with
    the mode read at run time and fixed at compile time, on the int32 and
    the int64 tile); then the tool's run (tools.probe_stages.measure_all,
    the quick target) with its guards, both fatal; one line per step: ps
    per sample and stage, SASS instructions per butterfly by class; and the
    round trip, the round-trip stage and three groups again on the tallest
    tile, [4096, 4], checked and timed the same way;
16. the compiled-code audit (tools/audit_sass.py, K11): the instruction
    count of every chain body (a count other than the known one is
    printed, not fatal: a toolkit may differ), the card's instructions/s
    from phase 11's reading of the two mixed chains and their count, and
    the headline kernel's count, static and summed over its groups, narrow
    and int64; the library's split of every factor size into groups equal
    to the audit's; a missing cuobjdump or an opcode in no class is a
    failure;
17. timing with CUDA events, kernel and plain version in turns (plain,
    kernel, kernel, plain), over chained calls (the wide path rereads one
    fixed input); every timed path beside its bound: the larger of its
    integer ops over the integer ceiling measured in phase 11 and its
    bytes (each input read once, each output written once) over the
    card's memory peak (memory clock x bus width, not the copy kernel's
    own reading), which reads the same work whatever implements it; beside
    it, for every FFT path, the issue limit of the code as compiled: the
    SASS instructions its groups issue per sample (phase 16) over the
    card's instructions/s, which falls when a design issues fewer
    instructions and so cannot show a redesign's gain; the config-2 chain and the convolution
    also with the host's time to issue one call beside the device time; the
    64k headline also as it read after phases 3, 12 and 16 and at the end,
    so that a reading that moves with what ran before it is seen to;
18. a JSON line describing each ported kernel, then the result line
    {"ok": true, "device": {...}} as the last line.
"""

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N, BATCH, CHAIN = 65536, 64, 50
CH, CH_N, CH_CHAIN, PLAIN_CHAIN = 4096, 4096, 20, 3
RT_BATCH = 8
N1M, B1M = 1 << 20, 4
N512K, B512K = 1 << 19, 8
N16M = 1 << 24
EPI_MODES = ("host", "device", "inkernel")
#: the 16M golden model runs when it is estimated under this many seconds
GOLDEN_16M_LIMIT_S = 60.0


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


def _clocks_line():
    """The card's SM and memory clocks, power draw and temperature now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


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


def _paced(fn, xr, xi, calls=CHAIN):
    """(device ms, host ms) per call of a chained fn: the time between two
    CUDA events around ``calls`` calls, and the host's clock from the first
    call to the return of the last, before any wait.  Where the two agree
    the card ran each call as it arrived and the host sets the pace; where
    the host is done long before the card, the card does."""
    import torch

    for _ in range(3):
        xr, xi = fn(xr, xi)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        xr, xi = fn(xr, xi)
    host = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls, host * 1e3 / calls


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
    started = time.perf_counter()

    def lap(phase):
        """The seconds the run has taken when ``phase`` starts."""
        print(f"[{time.perf_counter() - started:6.1f} s] phase {phase}",
              flush=True)

    from intfftk_tpu_torch.config import FFTConfig, snr_db
    from intfftk_tpu_torch.golden import (fft_int, make_conv_spec,
                                          overlap_save_int)
    from intfftk_tpu_torch.golden.float_model import bitrev_indices
    from intfftk_tpu_torch.golden.four_step import four_step_int
    from intfftk_tpu_torch.ops import _build
    from intfftk_tpu_torch.ops.fused_fft import (LargeFFTPlan,
                                                  circle_table, fused_pass,
                                                  fused_pass_reference)
    from intfftk_tpu_torch.ops.intmath import (cmult_exact, spectrum_product,
                                               spectrum_product_reference)
    from intfftk_tpu_torch.ops.single_pass import (PallasFFTPlan,
                                                   PallasWideFFTPlan)
    from intfftk_tpu_torch.ops.transform import pack_tables, pack_tables_2d
    from intfftk_tpu_torch.ops.twiddle_synth import (EpiSynth, coarse_table,
                                                     device_circle_table,
                                                     synth_circle_block)
    from intfftk_tpu_torch.parallel import Channelizer, OverlapSaveConv
    from intfftk_tpu_torch.tools import audit_sass, probe_stages, probe_vpu
    from intfftk_tpu_torch.tools.probe_vpu import (chain_reference,
                                                   copy_reference,
                                                   probe_chain, probe_copy)
    from intfftk_tpu_torch.utils import roofline
    from intfftk_tpu_torch.utils.roofline import (OPS_PER_SAMPLE_STAGE,
                                                  KernelCost, fft_cost,
                                                  large_fft_cost)

    # ---- 1. toolchain and build
    lap(1)
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
    entry = ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            # the mangled name without its source's anonymous namespace
            entry = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d*", "",
                           m.group(1))[:64]
        if "registers" in line or "bytes stack" in line:
            print(f"  ptxas {entry}: {line.split(':', 1)[-1].strip()}")
        if line.startswith("nvcc ") and line.rstrip().endswith(" s"):
            print(f"  {line.strip()}")

    # ---- 2. kernel against its plain version on the card
    lap(2)
    cfg = FFTConfig(n=N, mode="scaled", rounding="round", data_width=16,
                    twiddle_width=16)
    plan = LargeFFTPlan(cfg, device=dev)
    check((plan.n1, plan.n2, plan.io16) == (256, 256, True),
          "64k plan: 256 x 256 factors, int16 blocks")
    # largest |kernel - plain| over the comparisons of each ported kernel
    max_err = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K6": 0, "K1w": 0,
               "K2w": 0, "K5": 0, "K7": 0, "K8": 0, "K9": 0, "conv": 0,
               "K10": 0, "K11": 0, "P1": 0}

    def same(a, b, what, kernel="K1"):
        err = max(int((x.long() - y.long()).abs().max())
                  for x, y in zip(a, b))
        max_err[kernel] = max(max_err[kernel], err)
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"{what}: kernel == plain")

    def plain_blocks(p, xr, xi):
        """The plain version of a LargeFFTPlan's apply_blocks, on the card."""
        return p.apply_blocks(xr, xi, pass_fn=fused_pass_reference)

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
        return [torch.as_tensor(x).to(p.in_dtype).reshape(shape).to(dev)
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

    # the twiddle generator (K6): the device table == the host table;
    # "taylor_new" (XSER="NEW") has no pi constant for the 16M half-circle
    # order 23 (row_twiddle_tay.vhd:134-148), so the golden model has no
    # table there
    for n, n1, n2, gens in ((N512K, 1024, 512, ("auto", "taylor_new")),
                            (N1M, 1024, 1024, ("auto", "taylor_new")),
                            (N16M, 4096, 4096, ("auto",))):
        for gen in gens:
            c = FFTConfig(n=n, twiddle_gen=gen)
            for inverse in (False, True):
                host = [torch.as_tensor(t, device=dev)
                        for t in circle_table(c, n1, n2, inverse)]
                same(device_circle_table(c, n, n1, n2, inverse, dev), host,
                     f"generator [{n1}, {n2}] n={n} {gen} inverse="
                     f"{inverse} == host circle_table", "K6")
    # the in-kernel synthesis epilogue (K6 in K2) with the 1M plan's
    # synthesis constants, and a ragged 40-column prefix of its block
    c1m = FFTConfig(n=N1M, mode="scaled", rounding="round", data_width=16,
                    twiddle_width=16)
    f1k = dataclasses.replace(c1m, n=1024)
    t1k = [torch.as_tensor(t, device=dev) for t in pack_tables(f1k)]
    syn = EpiSynth(*coarse_table(c1m, dev), N1M)
    for nb, c, seed in ((B1M, 1024, 21), (3, 40, 22)):
        for inverse in (False, True):
            for adv in (False, True):
                x = [torch.as_tensor(v.reshape(nb, 1024, c),
                                     dtype=torch.int16, device=dev)
                     for v in _stimulus(nb, 1024 * c, seed, adversarial=adv)]
                kw = dict(synth=syn, transpose_out=True, inverse=inverse)
                same(fused_pass(*x, f1k, t1k, **kw),
                     fused_pass_reference(*x, f1k, t1k, **kw),
                     f"in-kernel epilogue pass [{nb}, 1024, {c}] int16 "
                     f"inverse={inverse}, adversarial {adv}", "K6")
    # the monolithic 2-D stage pass (K3): every stage multiplies
    for n, n1, n2, nb in ((N, 256, 256, BATCH), (N512K, 1024, 512, 2)):
        cm = FFTConfig(n=n, mode="scaled", rounding="round", data_width=16,
                       twiddle_width=16)
        fa = dataclasses.replace(cm, n=n1)
        t2 = [torch.as_tensor(t, device=dev)
              for t in pack_tables_2d(cm, n1, n2)]
        for inverse in (False, True):
            for natural in (True, False):
                x = [torch.as_tensor(v.reshape(nb, n1, n2),
                                     dtype=torch.int16, device=dev)
                     for v in _stimulus(nb, n, 23, adversarial=natural)]
                kw = dict(tables_2d=t2, transpose_out=not inverse,
                          inverse=inverse, natural=natural)
                same(fused_pass(*x, fa, None, **kw),
                     fused_pass_reference(*x, fa, None, **kw),
                     f"2-D stage pass [{nb}, {n1}, {n2}] inverse={inverse} "
                     f"natural={natural}", "K3")
    torch.cuda.synchronize()

    # ---- 3. the 64k forward path
    lap(3)
    xr, xi = _stimulus(BATCH, N, 5)
    x = blocks(plan, xr, xi)
    torch.cuda.synchronize()
    fused_pass.launches = 0
    yr, yi = plan.apply_blocks(*x)
    torch.cuda.synchronize()
    launches_64k = fused_pass.launches
    check(launches_64k == 2,
          f"64k path launched fused_pass {launches_64k} times")
    #: the headline's time at several points of the run: (ms per call, how
    #: many distinct output buffers the chained calls cycled through and the
    #: MiB their addresses span, the card's clocks, power and temperature
    #: just after)
    headline_at = {}

    def headline_now(where, x=x):
        seen = set()

        def call(a, b):
            y = plan.apply_blocks(a, b)
            seen.update(v.data_ptr() for v in y)
            return y

        ms = _event_ms(call, *x)
        headline_at[where] = (ms, len(seen), (max(seen) - min(seen)) >> 20,
                              _clocks_line())

    headline_now("after phase 3")
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
              f"64k {mode}/{rnd} x 2 ({p.in_dtype}): bit-equal to "
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
    lap(4)
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
    lap(5)
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
    lap(6)
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

    # ---- 7. the 1M block chain, per epilogue mode
    lap(7)
    def flat(y, nb):
        return [v.reshape(nb, -1).cpu().numpy() for v in y]

    def equal(y, g, nb):
        return all(np.array_equal(a, b) for a, b in zip(flat(y, nb), g))

    xr, xi = _stimulus(B1M, N1M, 24)
    t0 = time.perf_counter()
    g1 = four_step_int(xr, xi, c1m, 1024, 1024)
    golden_1m_s = (time.perf_counter() - t0) / B1M
    g2 = four_step_int(*g1, c1m, 1024, 1024)
    gi1 = four_step_int(xr, xi, c1m, 1024, 1024, inverse=True)
    print(f"  golden four_step_int at 1M: {golden_1m_s:.3f} s per item")
    chains, path_launches = {}, {}
    for mode in EPI_MODES:
        torch.cuda.synchronize()
        fused_pass.launches = device_circle_table.launches = 0
        a = LargeFFTPlan(c1m, epi_synth=mode, device=dev)
        b = LargeFFTPlan(c1m, a.n2, a.n1, epi_synth=mode, device=dev)
        x = blocks(a, xr, xi)
        y = a.apply_blocks(*x)
        la = fused_pass.launches
        z = b.apply_blocks(*y)
        torch.cuda.synchronize()
        counts = (fused_pass.launches, device_circle_table.launches)
        path_launches[mode] = counts
        what = f"1M block chain, epi_mode {mode}"
        check(a.epi_mode == b.epi_mode == mode
              and (a.n1, a.n2, a.io16) == (1024, 1024, True)
              and b.block_in_shape == a.block_out_shape, f"{what}: plans")
        check(la == 2 and counts[0] == 4, f"{what}: {counts[0]} launches, "
              f"2 per plan call")
        check(counts[1] == (2 if mode == "device" else 0),
              f"{what}: {counts[1]} generator launches (one per "
              f"device-mode plan, none per call)")
        check(equal(y, g1, B1M) and equal(z, g2, B1M),
              f"{what}: plan a and plan b, all {B1M} items bit-equal to "
              f"four_step_int")
        ip = LargeFFTPlan(c1m, inverse=True, epi_synth=mode, device=dev)
        before = fused_pass.launches
        w = ip.apply_blocks(*x)
        torch.cuda.synchronize()
        check(fused_pass.launches == before + 2 and equal(w, gi1, B1M),
              f"{what}: the inverse, 2 launches, bit-equal to "
              f"four_step_int(inverse=True)")
        same(z, plain_blocks(b, *y), f"{what}: plan b kernel == plain",
             "K6" if mode == "inkernel" else "K2")
        chains[mode] = (a, b, ip)

    # ---- 8. 512K on the flat contract, and 16M
    lap(8)
    c512 = dataclasses.replace(c1m, n=N512K)
    p512 = LargeFFTPlan(c512, device=dev)
    ip512 = LargeFFTPlan(c512, inverse=True, device=dev)
    check((p512.n1, p512.n2, p512.epi_mode) == (1024, 512, "device"),
          "512K plan: 1024 x 512, epi_mode device")
    xr, xi = _stimulus(B512K, N512K, 25)
    x512 = [torch.as_tensor(v, dtype=torch.int16, device=dev)
            for v in (xr, xi)]
    torch.cuda.synchronize()
    fused_pass.launches = 0
    y = p512(*x512)
    w = ip512(*x512)
    torch.cuda.synchronize()
    launches_512k = fused_pass.launches
    check(launches_512k == 4, f"512K flat forward + inverse: "
          f"{launches_512k} launches")
    check(equal([v[:2] for v in y], four_step_int(xr[:2], xi[:2], c512,
                                                 1024, 512), 2)
          and equal([v[:2] for v in w], four_step_int(
              xr[:2], xi[:2], c512, 1024, 512, inverse=True), 2),
          "512K flat x 8: forward and inverse, 2 items bit-equal to "
          "four_step_int")

    c16 = dataclasses.replace(c1m, n=N16M)
    xr, xi = _stimulus(1, N16M, 26)
    p16 = {}
    for mode in ("device", "inkernel"):
        torch.cuda.synchronize()
        fused_pass.launches = device_circle_table.launches = 0
        p = LargeFFTPlan(c16, epi_synth=mode, device=dev)
        x16 = blocks(p, xr, xi)
        y = p.apply_blocks(*x16)
        torch.cuda.synchronize()
        counts = (fused_pass.launches, device_circle_table.launches)
        path_launches["16M " + mode] = counts
        check((p.n1, p.n2) == (4096, 4096) and counts == (
            2, int(mode == "device")), f"16M {mode}: 4096 x 4096, "
            f"launches {counts}")
        same(y, plain_blocks(p, *x16), f"16M {mode}: kernel == plain",
             "K6" if mode == "inkernel" else "K2")
        p16[mode] = (p, y)
    estimate = golden_1m_s * 16 * 1.25
    if estimate < GOLDEN_16M_LIMIT_S:
        t0 = time.perf_counter()
        g = four_step_int(xr, xi, c16, 4096, 4096)
        golden_at = f"16M ({time.perf_counter() - t0:.1f} s of golden)"
        check(all(equal(y, g, 1) for _, y in p16.values()),
              f"16M device and inkernel: bit-equal to four_step_int")
    else:
        c4 = dataclasses.replace(c1m, n=1 << 22)
        xr, xi = _stimulus(1, 1 << 22, 27)
        g = four_step_int(xr, xi, c4, 2048, 2048)
        for mode in ("device", "inkernel"):
            p = LargeFFTPlan(c4, epi_synth=mode, device=dev)
            check(equal(p.apply_blocks(*blocks(p, xr, xi)), g, 1),
                  f"4M {mode}: bit-equal to four_step_int")
        golden_at = f"4M (the 16M golden was estimated at {estimate:.0f} s)"
    print(f"  the split pipeline's golden check ran at {golden_at}")

    # ---- 9. the monolithic schedule
    lap(9)
    mono = LargeFFTPlan(cfg, schedule="monolithic", device=dev)
    imono = LargeFFTPlan(cfg, inverse=True, schedule="monolithic",
                         device=dev)
    check((mono.n1, mono.n2, mono.io16, imono.block_in_shape)
          == (256, 256, True, (256, 256)), "monolithic 64k: 256 x 256, "
          "int16 blocks")
    xr, xi = _stimulus(BATCH, N, 28)
    x = blocks(mono, xr, xi)
    torch.cuda.synchronize()
    fused_pass.launches = 0
    y = mono.apply_blocks(*x)
    torch.cuda.synchronize()
    launches_mono = fused_pass.launches
    check(launches_mono == 2, f"monolithic 64k: {launches_mono} launches")
    gm = fft_int(xr, xi, cfg)
    check(equal(y, gm, BATCH), f"monolithic 64k x {BATCH}: all items "
          f"bit-equal to fft_int")
    same(y, plain_blocks(mono, *x), "monolithic 64k: kernel == plain", "K3")
    z = imono.apply_blocks(*y)
    rt = slice(0, 8)
    gr8, gi8 = fft_int(gm[0][rt], gm[1][rt], cfg, inverse=True)
    check(equal([v[rt] for v in z], (gr8, gi8), 8),
          "monolithic 64k roundtrip: 8 items bit-equal to the golden "
          "fft_int roundtrip")
    rawf = LargeFFTPlan(cfg, order="raw", schedule="monolithic", device=dev)
    rawi = LargeFFTPlan(cfg, inverse=True, order="raw",
                        schedule="monolithic", device=dev)
    o = rawf.raw_spectrum_order()
    before = fused_pass.launches
    ry = rawf.apply_blocks(*x)
    rz = rawi.apply_blocks(*ry)
    torch.cuda.synchronize()
    check(fused_pass.launches == before + 4
          and equal(ry, (gm[0][:, o], gm[1][:, o]), BATCH)
          and equal([v[rt] for v in rz], (gr8, gi8), 8),
          "monolithic 64k raw: forward bit-equal under raw_spectrum_order,"
          " raw inverse of it == the golden roundtrip")
    cm512 = dataclasses.replace(c1m, n=N512K)
    m512 = LargeFFTPlan(cm512, schedule="monolithic", device=dev)
    im512 = LargeFFTPlan(cm512, inverse=True, schedule="monolithic",
                         device=dev)
    xr, xi = _stimulus(2, N512K, 29)
    torch.cuda.synchronize()
    fused_pass.launches = 0
    y = m512.apply_blocks(*blocks(m512, xr, xi))
    w = im512.apply_blocks(*blocks(im512, xr, xi))
    torch.cuda.synchronize()
    launches_mono512 = fused_pass.launches
    check(launches_mono512 == 4, f"monolithic 512K forward + inverse: "
          f"{launches_mono512} launches")
    check(equal(y, fft_int(xr, xi, cm512), 2)
          and equal(w, fft_int(xr, xi, cm512, inverse=True), 2),
          "monolithic 512K x 2: forward and inverse bit-equal to fft_int")

    # ---- 10. the wide (> 32-bit) data path: int64 tiles
    lap(10)
    c2 = FFTConfig(n=N, mode="unscaled", data_width=32, twiddle_width=20)
    c2i = dataclasses.replace(c2, mode="scaled", rounding="round",
                              data_width=c2.output_width)
    f2 = LargeFFTPlan(c2, order="raw", device=dev)
    i2 = LargeFFTPlan(c2i, f2.n2, f2.n1, inverse=True, order="raw",
                      device=dev)
    c24 = FFTConfig(n=N, mode="unscaled", data_width=24, twiddle_width=16)
    w24 = LargeFFTPlan(c24, device=dev)
    check((f2.n1, f2.n2, f2.epi_mode, f2.wide_in, f2.wide1, f2.wide2)
          == (256, 256, "host", False, True, True)
          and (i2.wide_in, i2.wide1, i2.wide2) == (True, True, True)
          and i2.block_in_shape == f2.block_out_shape
          and (c2.output_width, c2i.output_width) == (48, 48),
          "config-2 plans: 256 x 256, host table, int32 -> int64 -> int64 "
          "forward (48 bits), int64 throughout the inverse")
    check((w24.wide1, w24.wide2, w24.mid_dtype, w24.out_dtype)
          == (False, True, torch.int32, torch.int64),
          "64k unscaled 24-bit: pass 1 narrow (32 bits), pass 2 widens to "
          "int64 (40 bits)")

    # (a) every wide pass form against its plain version: the config-2
    # passes at [8, 256, 256] and the widening pass at [64, 256, 256],
    # random and full-scale stimuli at 32 and 48 bits
    for p, w, nb in ((f2, 32, RT_BATCH), (i2, 48, RT_BATCH),
                     (w24, 24, BATCH)):
        for adv in (False, True):
            x = blocks(p, *_stimulus(nb, N, 31, adversarial=adv, w=w))
            for k, (c, kw) in enumerate(p.passes()):
                ref = fused_pass_reference(*x, c, **kw)
                same(fused_pass(*x, c, **kw), ref,
                     f"{c.n}-row pass {k + 1} of {p.in_dtype} -> "
                     f"{p.out_dtype} {'inverse' if p.inverse else 'forward'}"
                     f" {p.order} [{nb}, {c.n}, {N // c.n}] {c.data_width} -> "
                     f"{c.output_width} bits, adversarial {adv}",
                     "K2w" if p is w24 else "K1w")
                x = ref
    # ragged tiles, m = 8 to 4096 (TC 32 down to 2 on the int64 tile), the
    # widening pass on 32-bit data and the int64 pass on full-scale 52-bit
    # scaled/round data with 27-bit twiddles (an 80-bit product-sum)
    forms = ((False, False, True, True), (False, True, False, True),
             (False, False, True, False), (True, False, True, True),
             (True, False, False, False), (True, True, True, False),
             (True, True, False, True))
    for r, c, nb in ((8, 40, 3), (256, 40, 3), (512, 40, 3), (1024, 40, 3),
                     (4096, 40, 2)):
        for wide_in, inverse, natural, epi in forms:
            w = 52 if wide_in else 32
            cw = FFTConfig(n=r, mode="scaled" if wide_in else "unscaled",
                           rounding="round" if wide_in else "truncate",
                           data_width=w, twiddle_width=27)
            tw = [torch.as_tensor(t, device=dev) for t in pack_tables(cw)]
            e = ([torch.as_tensor(t, device=dev) for t in circle_table(
                dataclasses.replace(cw, n=r * 64), r, c, inverse,
                "natural" if natural else "raw")] if epi else None)
            kw = dict(epi=e, transpose_out=epi, inverse=inverse,
                      natural=natural, out_dtype=torch.int64)
            x = [torch.as_tensor(v.reshape(nb, r, c)).to(
                torch.int64 if wide_in else torch.int32).to(dev)
                for v in _stimulus(nb, r * c, r + c, w=w)]
            same(fused_pass(*x, cw, tw, **kw),
                 fused_pass_reference(*x, cw, tw, **kw),
                 f"wide pass [{nb}, {r}, {c}] {x[0].dtype} -> int64 "
                 f"{cw.mode} {w} -> {cw.output_width} bits, inverse="
                 f"{inverse} natural={natural} epilogue={epi}",
                 "K1w" if wide_in else "K2w")

    # (b) the config-2 chain at batch 8 (bench_config2): the raw unscaled
    # forward, the exact-unity 25-bit spectrum product (y * 2^23) >> 23 at
    # 48 bits (the product kernel, 128-bit product-sums), the raw
    # scaled/round inverse
    hr1 = torch.full(f2.block_out_shape, 1 << 23, dtype=torch.int32,
                     device=dev)
    hi1 = torch.zeros_like(hr1)

    def product(yr, yi, product_fn=spectrum_product):
        return product_fn(yr, yi, hr1, hi1, 23, c2.output_width, 25,
                          torch.int64)

    def c2_chain(a, b, pass_fn=fused_pass, product_fn=spectrum_product):
        y = f2.apply_blocks(a, b, pass_fn=pass_fn)
        return y, i2.apply_blocks(*product(*y, product_fn), pass_fn=pass_fn)

    def c2_plain(a, b):
        return c2_chain(a, b, fused_pass_reference,
                        spectrum_product_reference)

    rng = np.random.default_rng(0)
    xr, xi = (rng.integers(-(1 << 27), 1 << 27, (RT_BATCH, N))
              for _ in range(2))
    xr[0], xi[0] = -(1 << 31), -(1 << 31)          # the adversarial item
    xr[0, ::3] = (1 << 31) - 1
    x = blocks(f2, xr, xi)
    torch.cuda.synchronize()
    fused_pass.launches = spectrum_product.launches = 0
    y, z = c2_chain(*x)
    torch.cuda.synchronize()
    launches_c2 = fused_pass.launches
    product_launches = {"config 2": spectrum_product.launches}
    check(launches_c2 == 4 and product_launches["config 2"] == 1,
          f"config-2 chain: {launches_c2} pass launches, "
          f"{product_launches['config 2']} product launch")
    check(y[0].dtype == z[0].dtype == torch.int64
          and tuple(z[0].shape) == (RT_BATCH,) + f2.block_in_shape,
          "config-2 chain: int64 spectrum and output blocks")
    check(all(torch.equal(a, b) for a, b in zip(product(*y), y)),
          "the exact-unity spectrum product returns the spectrum")
    t0 = time.perf_counter()
    gr, gi = four_step_int(xr, xi, c2, f2.n1, f2.n2)
    o = f2.raw_spectrum_order()
    check(equal(y, (gr[:, o], gi[:, o]), RT_BATCH),
          f"config-2 forward half x {RT_BATCH}: bit-equal to four_step_int "
          f"(raw order, {c2.output_width} bits)")
    hr2, hi2 = four_step_int(gr, gi, c2i, i2.n1, i2.n2, inverse=True)
    golden_c2_s = time.perf_counter() - t0
    check(equal(z, (hr2, hi2), RT_BATCH),
          f"config-2 chain x {RT_BATCH}: bit-equal to four_step_int(inverse) "
          f"of the golden forward")
    zr, zi = flat(z, RT_BATCH)
    c2_snr = snr_db(xr[1:] + 1j * xi[1:], zr[1:] + 1j * zi[1:])
    print(f"  config-2 roundtrip SNR (unscaled forward, scaled/round "
          f"inverse, against x; 7 random items): {c2_snr:.2f} dB; golden "
          f"{golden_c2_s:.1f} s")
    check(np.isfinite(c2_snr), "config-2 SNR finite")
    # the chain timed here too, before the probes and the convolution have
    # run, beside the host's time to issue it (see the timing phase)
    c2_early = _paced(lambda a, b: (c2_chain(a, b), (a, b))[1], *x)

    # (c) the 64k widening pass 2 at batch 64
    xr, xi = _stimulus(BATCH, N, 33, w=24)
    x24 = blocks(w24, xr, xi)
    torch.cuda.synchronize()
    fused_pass.launches = 0
    y = w24.apply_blocks(*x24)
    torch.cuda.synchronize()
    launches_w24 = fused_pass.launches
    check(launches_w24 == 2, f"64k 24-bit widening: {launches_w24} "
          f"launches")
    check(y[0].dtype == torch.int64
          and equal(y, four_step_int(xr, xi, c24, w24.n1, w24.n2), BATCH),
          f"64k unscaled 24-bit x {BATCH}: int64, all items bit-equal to "
          f"four_step_int")

    # (d) K5: PallasWideFFTPlan on an int64 [4096, 1024] tile
    c5 = FFTConfig(n=4096, mode="unscaled", data_width=32, twiddle_width=16)
    rev = bitrev_indices(4096)
    xr, xi = _stimulus(1024, 4096, 34, w=32)            # [B, n]
    x5 = [torch.as_tensor(v.T.copy(), device=dev) for v in (xr, xi)]
    cols = np.arange(0, 1024, 16)                       # 64 golden columns
    k5 = {}

    def plain_wide(p, xr, xi):
        """The plain version of a PallasWideFFTPlan call, on the card."""
        n, shp = p.cfg.n, xr.shape
        yr, yi = fused_pass_reference(
            xr.reshape(1, n, -1), xi.reshape(1, n, -1), p.cfg,
            (p.w_re, p.w_im), inverse=p.inverse,
            natural=p.order == "natural", transpose_out=False,
            out_dtype=torch.int64)
        return yr.reshape(shp), yi.reshape(shp)

    torch.cuda.synchronize()
    fused_pass.launches = 0
    for inverse in (False, True):
        for order in ("natural", "bitrev"):
            p = PallasWideFFTPlan(c5, inverse=inverse, order=order,
                                  device=dev)
            k5[inverse, order] = p
            before = fused_pass.launches
            y = p(*x5)
            torch.cuda.synchronize()
            what = f"K5 [4096, 1024] int64 inverse={inverse} {order}"
            check(fused_pass.launches == before + 1
                  and y[0].dtype == torch.int64, f"{what}: 1 launch")
            same(y, plain_wide(p, *x5), what, "K5")
            src = ((xr[cols][:, rev], xi[cols][:, rev])
                   if order == "bitrev" and inverse
                   else (xr[cols], xi[cols]))
            g = fft_int(*src, c5, inverse=inverse)
            if order == "bitrev" and not inverse:
                g = [v[:, rev] for v in g]
            check(all(np.array_equal(v.cpu().numpy()[:, cols], h.T)
                      for v, h in zip(y, g)),
                  f"{what}: 64 columns bit-equal to fft_int "
                  f"({c5.output_width} bits)")
    launches_k5 = fused_pass.launches

    # ---- 11. the ceiling probes (K7-K9)
    lap(11)
    x32 = probe_vpu.chain_input(torch.int32, dev)
    x16 = probe_vpu.chain_input(torch.int16, dev)
    for body in probe_vpu.INT32_BODIES:
        for k in (1, 5, 64):
            same((probe_chain(body, x32, k),),
                 (chain_reference(body, x32, k),),
                 f"K7 chain {body} x {k} on int32 [{x32.numel()}]", "K7")
    for body in probe_vpu.INT16_BODIES:
        for k in (1, 5, 64):
            same((probe_chain(body, x16, k),),
                 (chain_reference(body, x16, k),),
                 f"K9 chain {body} x {k} on int16 [{x16.numel()}]", "K9")
    xc = torch.arange(-(1 << 25), 1 << 25, dtype=torch.int32, device=dev)
    oc = torch.empty_like(xc)
    same((probe_copy(xc, out=oc),), (copy_reference(xc),),
         f"K8 copy o = x + 1 over {xc.numel() * 4} bytes", "K8")
    torch.cuda.synchronize()
    probe_chain.launches = probe_chain.launches_int16 = 0
    probe_copy.launches = 0
    chain_launches = {}

    def count_chain(key, value):
        chain_launches[key] = probe_chain.launches - sum(
            chain_launches.values())

    try:
        ceilings = probe_vpu.measure_all(device=dev, emit=count_chain)
    except probe_vpu.GuardError as e:
        raise SmokeFailure(f"probe guard: {e}") from e
    torch.cuda.synchronize()
    probe_launches = (probe_chain.launches - probe_chain.launches_int16,
                      probe_copy.launches, probe_chain.launches_int16)
    check(all(c > 0 for c in probe_launches),
          f"the probe tool launched chain_kernel {probe_launches[0]} times "
          f"on int32 and {probe_launches[2]} on int16, copy_kernel "
          f"{probe_launches[1]} times; every chain linear in K "
          f"within {probe_vpu.LINEAR_TOL:.0%} at the first reading and below "
          f"the instruction peak "
          f"{probe_vpu.lane_rate_peak(dev) / 1e12:.2f} T lane-instr/s x "
          f"ops per instruction; the copy below the memory peak")
    print(f"ceilings on {card}: " + json.dumps(
        {k: v if v is None else round(v, 1) for k, v in ceilings.items()}))
    #: the roofline denominators of this run: the better mixed chain as
    #: measured, and the card's memory clock x bus width
    ceil = probe_vpu.ceilings_from(ceilings)
    print(f"  the bounds' ceilings: {ceil[0] / 1e12:.3f} T int ops/s "
          f"(measured), {ceil[1] / 1e12:.3f} TB/s (memory clock x bus "
          f"width); the copy kernel reached "
          f"{ceilings['hbm_bytes_per_s'] / 1e12:.3f} TB/s, "
          f"{ceilings['hbm_bytes_per_s'] / ceil[1]:.1%} of it")
    # ---- 12. overlap-save convolution (config 4)
    lap(12)
    spec = make_conv_spec(n=N, taps_len=(1 << 13) + 1, twiddle_width=16,
                          max_product_width=44, max_spectrum_width=25)
    rng = np.random.default_rng(1)
    m = spec.taps_len
    h_re = rng.integers(-(1 << 13), 1 << 13, m)
    h_im = np.zeros(m, np.int64)
    conv = OverlapSaveConv(spec, h_re, h_im)        # on the card by default
    check(conv.hr.device == dev and conv.large and conv.wide
          and (spec.product_width, spec.spectrum_width, spec.product_shift)
          == (44, 25, 14)
          and (conv.fwd.in_dtype, conv.fwd.out_dtype, conv.inv.in_dtype,
               conv.inv.out_dtype) == (torch.int32, torch.int32,
                                       torch.int64, torch.int64)
          and conv.inv.block_in_shape == conv.fwd.block_out_shape,
          "config-4 plan on the card: raw 256 x 256 pair, int32 forward "
          "(32 bits), 44-bit product, int64 inverse")
    conv_x, conv_launches, conv_snr = {}, {}, {}

    def conv_plain(u, v):
        """The plain version of the convolution's kernels, on the card."""
        return conv(u, v, pass_fn=fused_pass_reference,
                    product_fn=spectrum_product_reference)

    for payloads in (4, 64):
        t = spec.payload * payloads
        x_re = rng.integers(-(1 << 13), 1 << 13, t)
        x_im = rng.integers(-(1 << 13), 1 << 13, t)
        x = [torch.as_tensor(v, dtype=torch.int32, device=dev)
             for v in (x_re, x_im)]
        conv_x[payloads] = x
        torch.cuda.synchronize()
        fused_pass.launches = spectrum_product.launches = 0
        y = conv(*x)
        torch.cuda.synchronize()
        conv_launches[payloads] = fused_pass.launches
        product_launches[payloads] = spectrum_product.launches
        what = f"config 4, T = {payloads} payloads ({t} samples)"
        check(conv_launches[payloads] == 4 and product_launches[payloads] == 1
              and y[0].dtype == torch.int64 and tuple(y[0].shape) == (t,),
              f"{what}: {conv_launches[payloads]} pass launches, "
              f"{product_launches[payloads]} product launch, int64 [{t}]")
        same(y, conv_plain(*x), what, "conv")
        t0 = time.perf_counter()
        g = overlap_save_int(x_re, x_im, h_re, h_im, spec)
        golden_s = time.perf_counter() - t0
        check(all(np.array_equal(a.cpu().numpy(), b) for a, b in zip(y, g)),
              f"{what}: bit-equal to overlap_save_int ({golden_s:.1f} s of "
              f"golden)")
        size = 1 << (t + m).bit_length()
        ref = np.fft.ifft(np.fft.fft(x_re + 1j * x_im, size)
                          * np.fft.fft(h_re, size))[:t]
        conv_snr[payloads] = snr_db(
            ref / float(1 << spec.scale_log2),
            y[0].cpu().numpy() + 1j * y[1].cpu().numpy())
        check(np.isfinite(conv_snr[payloads]) and conv_snr[payloads] > 40,
              f"{what}: SNR {conv_snr[payloads]:.2f} dB against the float "
              f"FFT convolution")
    # the single-pass engine pair (n <= 4096), 2 launches per call
    spec4k = make_conv_spec(n=4096, taps_len=513)
    h4 = rng.integers(-(1 << 13), 1 << 13, (2, 513))
    x4 = rng.integers(-(1 << 13), 1 << 13, (2, 3, 8 * spec4k.payload))
    conv4k = OverlapSaveConv(spec4k, *h4)
    torch.cuda.synchronize()
    fused_pass.launches = spectrum_product.launches = 0
    y = conv4k(*x4)
    torch.cuda.synchronize()
    g = overlap_save_int(*x4, *h4, spec4k)
    check(fused_pass.launches == 2 and spectrum_product.launches == 1
          and y[0].dtype == torch.int32
          and all(np.array_equal(a.cpu().numpy(), b) for a, b in zip(y, g)),
          f"convolution n = 4096, 513 taps, [3, {x4.shape[-1]}]: "
          f"{fused_pass.launches} pass launches, "
          f"{spectrum_product.launches} product launch (int32 -> int32), "
          f"bit-equal to overlap_save_int")

    headline_now("after phase 12")

    # ---- 13. the spectrum product kernel (P1) against its plain version
    lap(13)
    prng = torch.Generator(device=dev).manual_seed(13)

    def full_scale(shape, bits, dtype):
        """Random ``bits``-bit values with both full-scale corners first."""
        lim = 1 << (bits - 1)
        v = torch.randint(-lim, lim, shape, dtype=torch.int64, device=dev,
                          generator=prng)
        v.view(-1)[:2] = torch.tensor([-lim, lim - 1], device=dev)
        return v.to(dtype)

    blk = conv.fwd.block_out_shape
    for what, shape, table, dw, dt, sw, shift, ow, odt in (
            ("config 4: int32 -> int64, 44 bits, +-2^31 data", (64,) + blk,
             blk, 32, torch.int32, 25, spec.product_shift, 44, torch.int64),
            ("config 2: int64, 48 bits, full-scale 25-bit table, 128-bit "
             "product-sums", (RT_BATCH,) + blk, blk, 48, torch.int64, 25, 23,
             48, torch.int64),
            ("int32 -> int32, 32 bits", (3, 4096), (4096,), 32, torch.int32,
             16, 15, 32, torch.int32),
            ("ragged: 3 x 1023 elements, int32 -> int64", (3, 1023), (1023,),
             32, torch.int32, 25, 14, 44, torch.int64)):
        fr, fi = full_scale(shape, dw, dt), full_scale(shape, dw, dt)
        tr, ti = (full_scale(table, sw, torch.int32) for _ in range(2))
        got = spectrum_product(fr, fi, tr, ti, shift, ow, sw, odt)
        want = cmult_exact(fr, fi, tr, ti, shift, ow, twiddle_width=sw)
        check(got[0].dtype == odt, f"P1 {what}: {odt} out")
        same(got, [w.to(odt) for w in want], f"P1 {what}", "P1")
    torch.cuda.synchronize()

    # ---- 14. more than 65 535 blocks in one call
    lap(14)
    c8 = FFTConfig(n=8, mode="scaled", rounding="round", data_width=16,
                   twiddle_width=16)
    t8 = [torch.as_tensor(t, device=dev) for t in pack_tables(c8)]
    x = [full_scale((65536, 8, 5), 16, torch.int16) for _ in range(2)]
    before = fused_pass.launches
    y = fused_pass(*x, c8, t8, transpose_out=True)
    torch.cuda.synchronize()
    check(fused_pass.launches == before + 2 and tuple(y[0].shape)
          == (65536, 5, 8), "fused_pass at batch 65 536: one call, 2 "
          "launches (65 535 items + 1), both counted")
    same(y, fused_pass_reference(*x, c8, t8, transpose_out=True),
         "fused_pass [65536, 8, 5] int16 (more items than one grid holds)",
         "K2")

    # every split of a factor into stage groups (m = 8: one group of 3; 16:
    # 3 + 1; 32: 3 + 2; 64: 3 + 3) on ragged column counts: the first group
    # reading device memory or the tile, the last writing device memory or
    # the tile, the product on the last group's registers; int32 and int64
    for r in (8, 16, 32, 64):
        cr = FFTConfig(n=r, mode="scaled", rounding="round", data_width=16,
                       twiddle_width=16)
        tr = [torch.as_tensor(t, device=dev) for t in pack_tables(cr)]
        for c in (1, 5, 33, 40):
            for inverse, natural, t_in, t_out in (
                    (False, True, False, False), (True, True, False, False),
                    (False, False, False, True), (True, False, True, False)):
                e = [torch.as_tensor(t, device=dev) for t in circle_table(
                    dataclasses.replace(cr, n=r * 64), r, c, inverse,
                    "natural" if natural else "raw")]
                kw = dict(epi=e, transpose_out=t_out, inverse=inverse,
                          natural=natural, transpose_in=t_in)
                for dt in (torch.int32, torch.int64):
                    x = [full_scale((3, c, r) if t_in else (3, r, c), 16, dt)
                         for _ in range(2)]
                    same(fused_pass(*x, cr, tr, out_dtype=dt, **kw),
                         fused_pass_reference(*x, cr, tr, out_dtype=dt, **kw),
                         f"group split of m = {r}, {c} columns, {dt}, "
                         f"inverse={inverse} natural={natural} turned in="
                         f"{t_in} out={t_out}", "K2")

    # ---- 15. the per-stage probe (K10)
    lap(15)
    stage_err = probe_stages.bit_checks(dev)
    max_err["K10"] = max(stage_err.values())
    check(max_err["K10"] == 0 and set(stage_err) == set(probe_stages.STEPS),
          f"K10: the once and the loop kernel of all {len(stage_err)} steps "
          f"== plain, every variant == its production step (unscaled and "
          f"scaled/round 16-bit data, k = 1 and up to "
          f"{probe_stages.MAX_CHECK_K})")
    sass = audit_sass.library_sass()
    stage_counts = {step: audit_sass.audit_stage(step, sass)
                    for step in probe_stages.STEPS}
    stage_ns = {}

    def stage_line(step, r):
        stage_ns[step] = r.ns_per_sample_per_stage
        per = audit_sass.summarize(stage_counts[step])
        print(f"  {step:17s} {r.ns_per_sample_per_stage * 1e3:7.3f} ps per "
              f"sample and stage ({probe_stages.STEPS[step].stages} a "
              f"step); SASS per butterfly: issued "
              f"{per['issued']:g} (alu {per['alu']:g}, move {per['move']:g}, "
              f"memory and barrier {per['mem']:g}, control "
              f"{per['control']:g}, uniform {per['uniform']:g}; FMA pipe "
              f"{per['fma_pipe']:g}, ALU pipe {per['alu_pipe']:g})",
              flush=True)

    torch.cuda.synchronize()
    probe_stages.stage_loop.launches = 0
    try:
        probe_stages.measure_all(quick=True, device=dev, emit=stage_line,
                                 check=False)
    except probe_vpu.GuardError as e:
        raise SmokeFailure(f"stage probe guard: {e}") from e
    torch.cuda.synchronize()
    stage_launches = probe_stages.stage_loop.launches
    check(stage_launches > 0 and set(stage_ns) == set(probe_stages.STEPS),
          f"the stage probe launched stage_loop_kernel {stage_launches} "
          f"times; every step linear in k within "
          f"{probe_vpu.LINEAR_TOL:.0%}, no production step above the "
          f"instruction peak / {probe_stages.ARITH12_OPS}")
    print(f"stage probe on {card}: " + json.dumps(
        {k: round(v, 6) for k, v in stage_ns.items()}))
    # the tallest tile, [4096, 4] with rows padded to 5 words (the
    # channelizer's passes, one CTA per SM): the round trip, the round-trip
    # stage and the groups again, where a group's strided rows meet bank
    # conflicts that the [256, 16] tile does not have
    tall = probe_stages.TALL_STEPS
    tall_err = probe_stages.bit_checks(dev, probe_stages.TALL_ROWS, tall)
    check(max(tall_err.values()) == 0 and set(tall_err) == set(tall),
          f"K10 on the [{probe_stages.TALL_ROWS}, 4] tile: {len(tall)} steps "
          f"== plain (unscaled and scaled/round)")
    main_ns, stage_ns = stage_ns, {}
    try:
        probe_stages.measure_all(quick=True, device=dev, emit=stage_line,
                                 steps=tall, check=False,
                                 n=probe_stages.TALL_ROWS)
    except probe_vpu.GuardError as e:
        raise SmokeFailure(f"stage probe guard, tall tile: {e}") from e
    print(f"stage probe on the [{probe_stages.TALL_ROWS}, 4] tile on {card}: "
          + json.dumps({k: round(v, 6) for k, v in stage_ns.items()}))
    stage_ns = main_ns

    # ---- 16. the compiled-code audit (K11)
    lap(16)
    unknown = sorted({i.opcode for ins in sass.values() for i in ins
                      if audit_sass.classify(i.opcode) == "unknown"})
    check(not unknown, f"every opcode of the library's SASS "
          f"({sum(map(len, sass.values()))} instructions in {len(sass)} "
          f"functions) falls in a class {unknown}")
    known = {"mixed7": 4, "stagemix10": 7}
    for body in probe_vpu.INT32_BODIES:
        per = audit_sass.summarize(audit_sass.audit_probe_chain(
            body, sass).scaled(audit_sass.CHAINS_PER_THREAD))
        note = ""
        if body in known and per["issued"] != known[body]:
            note = f" (an earlier toolkit compiled {known[body]})"
        print(f"  chain {body}: {per['issued']:g} instructions per iteration "
              f"and chain for {probe_vpu.BODIES[body].ops} source ops{note}")
    for body in ("mixed7", "stagemix10"):
        same((probe_chain(body, x32, 64),), (chain_reference(body, x32, 64),),
             f"K11's counted chain {body} x 64", "K11")
    # one reading for both bounds: phase 11's, counted here
    audit_launches = sum(chain_launches[probe_vpu.BODIES[b].key]
                         for b in ("mixed7", "stagemix10"))
    instr_rate = roofline.instruction_rate(ceilings, sass)
    check(audit_launches > 0 and instr_rate > 0,
          f"K11: the two mixed chains of phase 11's reading "
          f"({audit_launches} launches of chain_kernel) counted: "
          f"{instr_rate / 1e12:.3f} T instructions/s, "
          f"{instr_rate / probe_vpu.lane_rate_peak(dev):.1%} of the lane "
          f"peak")
    headline = audit_sass.audit_headline(sass)
    for name, h in headline.items():
        st = audit_sass.summarize(h["static_per_butterfly"])
        ps_ = audit_sass.summarize(h["per_sample"])
        print(f"  headline 256 x 256, {name}: the pass's largest group loop "
              f"{st['issued']:g} instructions per butterfly (static: both "
              f"operand sources, both destinations, both product forms); "
              f"its groups {audit_sass.group_split(8, name == 'int64')}, "
              f"summed from the group steps: {ps_['issued']:g} per sample "
              f"(alu {ps_['alu']:g}, move {ps_['move']:g}, memory and "
              f"barrier {ps_['mem']:g}, control {ps_['control']:g}, uniform "
              f"{ps_['uniform']:g}) against {17 * OPS_PER_SAMPLE_STAGE:g} "
              f"hand-counted source ops")
    for wide in (False, True):
        for log_rows in range(3, 13):
            check(probe_stages.library_group_split(log_rows, wide)
                  == audit_sass.group_split(log_rows, wide),
                  f"group split of 2^{log_rows} rows, "
                  f"{'int64' if wide else 'int32'} tile: the library's == "
                  f"the audit's {audit_sass.group_split(log_rows, wide)}")
    alu64k, move64k = roofline.audit_kernel_ops(cfg, 256, 256, sass=sass)
    check(alu64k + move64k == audit_sass.issued(
        headline["narrow"]["per_sample"]),
        f"audit_kernel_ops(64k, 256, 256): {alu64k:g} alu + {move64k:g} "
        f"other instructions per sample")

    headline_now("after phase 16")

    # ---- 17. timing, kernel and plain in turns
    # (from an empty allocator cache, so that where the earlier phases left
    # their blocks does not place this phase's buffers)
    lap(17)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    def bound(cost):
        """(bound in ms, which ceiling sets it) of a KernelCost against
        this run's ceilings (``ceil``)."""
        ops_s, bytes_s = cost.int_ops / ceil[0], cost.hbm_bytes / ceil[1]
        return (max(ops_s, bytes_s) * 1e3,
                "operations" if ops_s >= bytes_s else "bytes")

    def work(samples, stage_equiv, nbytes):
        """The cost of a chain of transforms as one function: 12 ops per
        sample per stage-equivalent (a stage, an inter-factor twiddle or a
        pointwise product), and the bytes of its first input and last
        output."""
        return KernelCost(OPS_PER_SAMPLE_STAGE * samples * stage_equiv,
                          nbytes)

    def t_instr(n1, n2=1, wide=False, **kw):
        """Instructions per sample the groups of an n1 x n2 transform issue
        (and its inter-factor product), from the SASS of phase 16; the
        probe holds the forward groups, which stand for the inverse's."""
        return audit_sass.issued(audit_sass.audit_transform(n1, n2, wide,
                                                            sass, **kw))

    def counted(cost, samples, per_sample):
        """``cost`` with the instructions its stages issue; load, store and
        reorder of each pass and the spectrum product are not in them."""
        return dataclasses.replace(
            cost, instructions=None if per_sample is None
            else samples * per_sample)

    def instr_bound_ms(cost):
        return (None if cost.instructions is None
                else cost.instruction_bound(instr_rate) * 1e3)

    def share(k_ms, cost):
        """The time beside its two yardsticks: the bound, which reads the
        same work whatever implements it (bytes over the card's memory
        peak, or 12 source-level ops per sample and stage over the measured
        integer ceiling), and the issue limit of the code as compiled (its
        counted instructions over the measured instructions/s), which
        falls when a design issues fewer instructions."""
        b, by = bound(cost)
        out = f"; bound {b:.4f} ms ({by}), time / bound {k_ms / b:.2f}"
        ib = instr_bound_ms(cost)
        if ib is not None:
            out += (f"; issue limit of the code as compiled {ib:.4f} ms, "
                    f"time / issue limit {k_ms / ib:.2f}")
        return out

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
    cost_64k = counted(large_fft_cost(N, BATCH, itemsize=2), samples,
                       t_instr(256, 256))
    paced_64k = _paced(lambda a, b: plan.apply_blocks(a, b), *x)
    print(f"timing on {card}, CUDA events, mean of chained calls (clocks, "
          f"power and temperature after the first path: {_clocks_line()}):")
    print(f"  64k [64, 256, 256] int16 apply_blocks: kernel {k_ms:.4f} "
          f"ms/call ({ms['kernel'][0]:.4f}, {ms['kernel'][1]:.4f}), "
          f"{samples / k_ms / 1e3:.1f} Msamples/s, "
          f"{moved / k_ms / 1e6:.1f} GB/s; pass 1 {pass1:.4f} ms, pass 2 "
          f"{pass2:.4f} ms; plain {p_ms:.4f} ms ({ms['plain'][0]:.4f}, "
          f"{ms['plain'][1]:.4f})" + share(k_ms, cost_64k))
    print(f"    device ms / host ms to issue one call: {paced_64k[0]:.4f} / "
          f"{paced_64k[1]:.4f}")
    x_64k = x

    def roundtrip(a, b):
        return inv.apply_blocks(*fwd.apply_blocks(a, b))

    def roundtrip_plain(a, b):
        return plain_blocks(inv, *plain_blocks(fwd, a, b))

    x = blocks(fwd, *_stimulus(RT_BATCH, N, 14))
    # two transforms with their inter-factor twiddles; int16 in and out
    cost_rt = counted(work(RT_BATCH * N, 2 * 17, RT_BATCH * N * 2 * (2 + 2)),
                      RT_BATCH * N, 2 * t_instr(256, 256))
    rt_ms, rt_plain, rms = _turns(roundtrip, roundtrip_plain, *x, CHAIN,
                                  10)
    print(f"  64k raw roundtrip [8, 256, 256] int16 (4 launches): kernel "
          f"{rt_ms:.4f} ms ({rms['kernel'][0]:.4f}, {rms['kernel'][1]:.4f}),"
          f" {2 * RT_BATCH * N / rt_ms / 1e3:.1f} Msamples/s of transforms;"
          f" plain {rt_plain:.4f} ms ({rms['plain'][0]:.4f}, "
          f"{rms['plain'][1]:.4f})" + share(rt_ms, cost_rt))

    ch_ms = {}
    csamples = CH * CH_N
    cbytes = csamples * 2 * 4 * 2          # re/im x int32 x (in + out)
    cost_ch = counted(fft_cost(CH_N, CH), csamples, t_instr(CH_N))
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
              f" ({cms['plain'][0]:.4f}, {cms['plain'][1]:.4f})"
              + share(km, cost_ch))
    for layout, st in stream_stats.items():
        print(f"  streamed Channelizer {layout} (lane_tile 512, depth 4): "
              f"wall {st['wall_s'] * 1e3:.2f} ms for {CH} channels, "
              f"{st['msamples_per_s']:.1f} Msamples/s")

    def report(what, samples, k, pl, turns, moved=None, cost=None):
        gbs = f", {moved / k / 1e6:.1f} GB/s" if moved else ""
        print(f"  {what}: kernel {k:.4f} ms ({turns['kernel'][0]:.4f}, "
              f"{turns['kernel'][1]:.4f}), {samples / k / 1e3:.1f} "
              f"Msamples/s{gbs}; plain {pl:.4f} ms ({turns['plain'][0]:.4f}, "
              f"{turns['plain'][1]:.4f})" + (share(k, cost) if cost else ""))

    # int16 re/im in and out of two passes, per transformed sample
    io_bytes = 2 * 2 * 2 * 2
    x = blocks(chains["host"][0], *_stimulus(B1M, N1M, 24))
    chain_ms = {}
    cost_1m = counted(work(2 * B1M * N1M, 21, B1M * N1M * 2 * (2 + 2)),
                      B1M * N1M, 2 * t_instr(1024, 1024))
    for mode, (a, b, _) in chains.items():
        chain_ms[mode] = _turns(
            lambda u, v, a=a, b=b: b.apply_blocks(*a.apply_blocks(u, v)),
            lambda u, v, a=a, b=b: plain_blocks(b, *plain_blocks(a, u, v)),
            *x, 20, 2)
        report(f"1M block chain [4, 1024, 1024] int16, plan a + plan b "
               f"(4 launches), epi_mode {mode}", 2 * B1M * N1M,
               *chain_ms[mode], moved=2 * B1M * N1M * io_bytes,
               cost=cost_1m)
    pass1_1m = {}
    for mode, (a, _, _) in chains.items():
        c, kw = a.passes()[0]             # [4, 1024, 1024] in and out
        pass1_1m[mode] = _event_ms(lambda u, v, c=c, kw=kw: fused_pass(
            u, v, c, **kw), *x, calls=20)
    print("  1M pass 1 alone (ms): " + ", ".join(
        f"{m} {t:.4f}" for m, t in pass1_1m.items()))
    gen_ms = {}
    # the generator: about 25 integer ops per entry (the hand count of
    # csrc/fused_pass.cu) and 8 bytes written
    cost_gen = {n: KernelCost(25.0 * n, 8.0 * n) for n in (N1M, N16M)}
    for n, n1 in ((N1M, 1024), (N16M, 4096)):
        c = dataclasses.replace(c1m, n=n)
        co = coarse_table(c, dev)
        gen_ms[n] = _turns(
            lambda u, v, c=c, n=n, n1=n1, co=co: device_circle_table(
                c, n, n1, n1, False, coarse=co),
            lambda u, v, c=c, n=n, n1=n1, co=co: synth_circle_block(
                co, n1, n1, 0, n, c, False), None, None, 20, 2)
        report(f"generator, one [{n1}, {n1}] table (n = {n}; coarse table "
               f"on the card)", n, *gen_ms[n], moved=8 * n,
               cost=cost_gen[n])
    x = x512
    cost_512k = counted(large_fft_cost(N512K, B512K, itemsize=2),
                        B512K * N512K, t_instr(1024, 512))
    cost_16m = counted(large_fft_cost(N16M, 1, itemsize=2), N16M,
                       t_instr(4096, 4096))
    # monolithic: the single full-size core's stages, no epilogue
    # (the stages with 2-D tables multiply at every order: counted as the
    # multiplying stage, whose table read is one word nearer)
    cost_mono = counted(work(BATCH * N, 16, BATCH * N * 2 * (2 + 2)),
                        BATCH * N, t_instr(256, 256, two_d=True,
                                           product=False))
    cost_mono512 = counted(work(2 * N512K, 19, 2 * N512K * 2 * (2 + 2)),
                           2 * N512K, t_instr(1024, 512, two_d=True,
                                              product=False))
    k512 = _turns(p512, lambda u, v: p512.apply_blocks(
        *(t.reshape((B512K,) + p512.block_in_shape) for t in (u, v)),
        pass_fn=fused_pass_reference), *x, 20, 2)
    report(f"512K flat [{B512K}, {N512K}] int16 forward (2 launches)",
           B512K * N512K, *k512, moved=B512K * N512K * io_bytes,
           cost=cost_512k)
    xr, xi = _stimulus(1, N16M, 26)
    p16["host"] = (LargeFFTPlan(c16, epi_synth="host", device=dev), None)
    ms16 = {}
    for mode in EPI_MODES:
        p = p16[mode][0]
        ms16[mode] = _turns(lambda u, v, p=p: p.apply_blocks(u, v),
                            lambda u, v, p=p: plain_blocks(p, u, v),
                            *blocks(p, xr, xi), 10, 1)
        report(f"16M [1, 4096, 4096] int16 apply_blocks, epi_mode {mode}",
               N16M, *ms16[mode], moved=N16M * io_bytes, cost=cost_16m)
    x = blocks(mono, *_stimulus(BATCH, N, 28))
    mono_ms = _turns(lambda u, v: mono.apply_blocks(u, v),
                     lambda u, v: plain_blocks(mono, u, v), *x, CHAIN, 10)
    report("monolithic 64k [64, 256, 256] int16 apply_blocks", BATCH * N,
           *mono_ms, moved=BATCH * N * io_bytes, cost=cost_mono)
    x = [torch.as_tensor(v, dtype=torch.int16, device=dev)
         for v in _stimulus(2, N512K, 29)]
    mono512_ms = _turns(m512, lambda u, v: m512.apply_blocks(
        *(t.reshape((2,) + m512.block_in_shape) for t in (u, v)),
        pass_fn=fused_pass_reference), *x, CHAIN, 10)
    report("monolithic 512K flat [2, 524288] int16 forward", 2 * N512K,
           *mono512_ms, moved=2 * N512K * io_bytes, cost=cost_mono512)

    # the wide path: int64 outputs do not feed the next call's int32
    # input, so each timed call rereads one fixed input
    def fixed(fn):
        return lambda a, b: (fn(a, b), (a, b))[1]

    rng = np.random.default_rng(0)
    x = blocks(f2, *(rng.integers(-(1 << 27), 1 << 27, (RT_BATCH, N))
                     for _ in range(2)))
    # two transforms, their twiddles and the product; int32 in, int64 out,
    # the [n] int64 spectrum table read once.  The bound counts 32-bit
    # ops; the int64 tile does 64-bit sums and 128-bit products for each.
    # The issue limit counts the int64 tile's own kernels.
    cost_c2 = counted(work(RT_BATCH * N, 2 * 17 + 1,
                           RT_BATCH * N * 2 * (4 + 8) + N * 2 * 4),
                      RT_BATCH * N, 2 * t_instr(256, 256, wide=True))
    cost_w24 = counted(KernelCost(large_fft_cost(N, BATCH).int_ops,
                                  BATCH * N * 2 * (4 + 8)), BATCH * N,
                       t_instr(256, product=True)
                       + t_instr(256, wide=True))
    cost_k5 = counted(KernelCost(fft_cost(4096, 1024).int_ops,
                                 4096 * 1024 * 2 * (8 + 8)), 4096 * 1024,
                      t_instr(4096, wide=True))
    c2_ms = _turns(fixed(c2_chain), fixed(c2_plain), *x, CHAIN, 3)
    report(f"config-2 chain [{RT_BATCH}, {f2.n1}, {f2.n2}] int32 -> int64 "
           f"(4 pass launches + 1 product launch)", 2 * RT_BATCH * N, *c2_ms,
           cost=cost_c2)
    c2_late = _paced(fixed(c2_chain), *x)
    print(f"  config-2 chain, device ms / host ms to issue one call: "
          f"{c2_early[0]:.4f} / {c2_early[1]:.4f} before the probe and "
          f"convolution phases, {c2_late[0]:.4f} / {c2_late[1]:.4f} here")
    y = f2.apply_blocks(*x)
    steps = {"forward pass 1 (int32 -> int64, host table)": (f2, 0, x),
             "forward pass 2 (int64)": (f2, 1, fused_pass(
                 *x, f2.cfg1, **f2.passes()[0][1])),
             "inverse pass 1 (int64, host table)": (i2, 0, y),
             "inverse pass 2 (int64)": (i2, 1, fused_pass(
                 *y, i2.cfg1, **i2.passes()[0][1]))}
    step_ms = {what: _event_ms(fixed(
        lambda u, v, c=p.passes()[k][0], kw=p.passes()[k][1]: fused_pass(
            u, v, c, **kw)), *xs) for what, (p, k, xs) in steps.items()}
    step_ms["spectrum product (kernel)"] = _event_ms(fixed(product), *y)
    print("  config-2 chain steps (ms): " + ", ".join(
        f"{what} {t:.4f}" for what, t in step_ms.items()))
    w24_ms = _turns(fixed(w24.apply_blocks), fixed(
        lambda u, v: plain_blocks(w24, u, v)), *x24, CHAIN, 3)
    report(f"64k unscaled 24-bit [{BATCH}, {w24.n1}, {w24.n2}] int32 -> "
           f"int64 apply_blocks (2 launches)", BATCH * N, *w24_ms,
           moved=BATCH * N * 2 * (4 + 4 + 4 + 8), cost=cost_w24)
    k5_ms = {}
    for (inverse, order), p in k5.items():
        k5_ms[inverse, order] = _turns(fixed(p), fixed(
            lambda u, v, p=p: plain_wide(p, u, v)), *x5, CHAIN, 3)
        report(f"K5 PallasWideFFTPlan [4096, 1024] int64 inverse={inverse} "
               f"{order}", 4096 * 1024, *k5_ms[inverse, order],
               moved=4096 * 1024 * 2 * 2 * 8, cost=cost_k5)

    # config 4: per block a forward, the product and an inverse; the
    # int32 signal in, the int64 payload out, the [n] int32 taps spectrum
    conv_ms, cost_conv = {}, {}
    for payloads, x in conv_x.items():
        t = spec.payload * payloads
        cost_conv[payloads] = counted(
            work(payloads * N, 2 * 17 + 1, t * 2 * (4 + 8) + N * 2 * 4),
            payloads * N, t_instr(256, 256) + t_instr(256, 256, wide=True))
        conv_ms[payloads] = _turns(fixed(conv), fixed(conv_plain), *x,
                                   CHAIN if payloads == 4 else 20, 2)
        report(f"config 4 overlap-save, T = {payloads} payloads [{t}] int32 "
               f"-> int64 (4 pass launches + 1 product launch + windows, "
               f"cut; payload samples)", t, *conv_ms[payloads],
               cost=cost_conv[payloads])
        paced = _paced(fixed(conv), *x, calls=20)
        print(f"    device ms / host ms to issue one call: {paced[0]:.4f} / "
              f"{paced[1]:.4f}")

    # the T = 64 call's steps, each alone on a fixed input
    x = conv_x[64]
    t = x[0].shape[-1]

    def windows(v):
        e = torch.nn.functional.pad(v.reshape(1, t), (m - 1, 0))
        return e.unfold(-1, N, spec.payload).reshape(
            (-1,) + conv.fwd.block_in_shape).contiguous()

    def conv_product(u, v, product_fn=spectrum_product):
        return product_fn(u, v, conv.hr, conv.hi, spec.product_shift,
                          spec.product_width, spec.spectrum_width,
                          torch.int64)

    def cut(v):
        return v.reshape(-1, N)[:, m - 1:].reshape(t)

    b = [windows(v) for v in x]
    f = conv.fwd.apply_blocks(*b)
    pq = conv_product(*f)
    z = conv.inv.apply_blocks(*pq)
    conv_steps = {what: _event_ms(fixed(fn), *xs, calls=20)
                  for what, fn, xs in (
        ("windows (pad, unfold, copy)",
         lambda u, v: (windows(u), windows(v)), x),
        ("forward (int32, 2 launches)", conv.fwd.apply_blocks, b),
        ("product (kernel, 44 bits)", conv_product, f),
        ("inverse (int64, 2 launches)", conv.inv.apply_blocks, pq),
        ("cut", lambda u, v: (cut(u), cut(v)), z))}
    print("  config 4, T = 64 payloads, steps (ms): " + ", ".join(
        f"{what} {ms:.4f}" for what, ms in conv_steps.items()))

    # P1 alone on the T = 64 call's spectrum: one pointwise product per
    # sample; each datum read, each result written, the table read once
    cost_p1 = KernelCost(OPS_PER_SAMPLE_STAGE * f[0].numel(),
                         f[0].numel() * 2 * (4 + 8) + N * 2 * 4)
    p1_ms = _turns(fixed(conv_product), fixed(
        lambda u, v: conv_product(u, v, spectrum_product_reference)), *f,
        CHAIN, 5)
    report(f"P1 spectrum product {list(f[0].shape)} int32 x [256, 256] int32 "
           f"table -> int64, 44 bits", f[0].numel(), *p1_ms,
           moved=cost_p1.hbm_bytes, cost=cost_p1)

    # K10 at the tool's shape: the production stage of order 7, K_STAGE
    # applications on the tile that fills the card
    K_STAGE = 16
    pcfg = probe_stages.probe_config()
    sx = probe_stages.stage_input("prod_p7", pcfg, dev)
    stab = probe_stages.stage_tables(pcfg, dev)
    k10_ms = _turns(
        fixed(lambda u, v: probe_stages.stage_loop("prod_p7", u, v, K_STAGE,
                                                   pcfg, stab)),
        fixed(lambda u, v: probe_stages.stage_loop_reference(
            "prod_p7", u, v, K_STAGE, pcfg, stab)), *sx, 20, 1)
    cost_k10 = counted(
        KernelCost(OPS_PER_SAMPLE_STAGE * sx[0].numel() * K_STAGE,
                   2 * 2 * sx[0].numel() * 4),
        sx[0].numel(), K_STAGE * 0.5 * audit_sass.issued(
            stage_counts["prod_p7"]))
    report(f"K10 stage loop prod_p7 x {K_STAGE} on int32 "
           f"{list(sx[0].shape)}", sx[0].numel(), *k10_ms, cost=cost_k10)

    # the probes at the tool's shape: a chain of K_ROW iterations
    K_ROW = 256
    probe_ms, cost_probe = {}, {}
    for name, body, xs in (("K7", "stagemix10", x32), ("K9", "add", x16),
                           ("K11", "mixed7", x32)):
        probe_ms[name] = _turns(
            fixed(lambda u, v, b=body: probe_chain(b, u, K_ROW)),
            fixed(lambda u, v, b=body: chain_reference(b, u, K_ROW)),
            xs, None, 20, 2)
        cost_probe[name] = counted(KernelCost(
            xs.numel() * probe_vpu.BODIES[body].ops * K_ROW,
            2 * xs.numel() * xs.element_size()), xs.numel(),
            K_ROW * audit_sass.issued(audit_sass.audit_probe_chain(
                body, sass).scaled(audit_sass.CHAINS_PER_THREAD))
            if xs is x32 else None)
        report(f"{name} chain {body} x {K_ROW} on {xs.dtype} "
               f"[{xs.numel()}]", xs.numel(), *probe_ms[name],
               cost=cost_probe[name])
    probe_ms["K8"] = _turns(fixed(lambda u, v: probe_copy(u, out=oc)),
                            fixed(lambda u, v: copy_reference(u)), xc, None,
                            20, 5)
    add_ms = _event_ms(fixed(lambda u, v: torch.add(u, 1, out=oc)), xc, None,
                       calls=20)
    cost_probe["K8"] = KernelCost(xc.numel(), 2 * xc.numel() * 4)
    report(f"K8 copy o = x + 1 over {xc.numel() * 4} bytes each way "
           f"(torch.add: {add_ms:.4f} ms)", xc.numel(), *probe_ms["K8"],
           moved=2 * xc.numel() * 4, cost=cost_probe["K8"])
    headline_now("after phase 17's other paths", x_64k)
    print("  64k headline through the run, ms per call (distinct output "
          "buffers of the chained calls, the MiB their addresses span; SM "
          "MHz, memory MHz, W, temperature just after): " + "; ".join(
              f"{where} {t:.4f} ({bufs} buffers over {span} MiB; {clk})"
              for where, (t, bufs, span, clk) in headline_at.items()))
    check("jax" not in sys.modules and not any(
        m == "intfftk_tpu" or m.startswith("intfftk_tpu.")
        for m in sys.modules),
        "neither JAX nor the JAX package was imported")

    # ---- 18. results
    lap(18)
    src = "intfftk_tpu_torch/csrc/fused_pass.cuh"
    psrc = "intfftk_tpu_torch/csrc/probe.cu"
    mean = lambda layout, k=0: sum(ch_ms[layout, inverse][k]
                                   for inverse in (False, True)) / 2
    k1 = "intfftk_tpu/ops/pallas_fft.py:1255"
    k2 = "intfftk_tpu/ops/pallas_fft.py:965"
    k6 = "intfftk_tpu/ops/twiddle_synth.py:126"
    k3 = "intfftk_tpu/ops/pallas_fft.py:1204"
    kernels = []

    def row(name, replaces, launches, err, ms, plain_ms, cost, source=src,
            library_ms=None):
        """One kernel row; the bound is of the timed call's work against
        this run's ceilings."""
        b_ms, by = bound(cost)
        kernels.append(
            {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "max_abs_err": max_err[err], "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": by, "library_ms": library_ms,
             "issue_limit_ms": instr_bound_ms(cost)})

    row("fused_pass: K1 four-step, forward natural (64k apply_blocks)", k1,
        launches_64k, "K1", k_ms, p_ms, cost_64k)
    row("fused_pass: K1 four-step, raw forward + raw inverse (64k "
        "roundtrip)", k1, launches_rt, "K1", rt_ms, rt_plain, cost_rt)
    row("fused_pass: K2 transposed load and store (Channelizer cn, fwd + "
        "inv; timed: one call)", k2, ch_launches["cn"], "K2", mean("cn"),
        mean("cn", 1), cost_ch)
    row("fused_pass: K4 single pass [n, B] (Channelizer nc, fwd + inv; "
        "timed: one call)", "intfftk_tpu/ops/pallas_fft.py:829",
        ch_launches["nc"], "K4", mean("nc"), mean("nc", 1), cost_ch)
    for mode in EPI_MODES:
        row(f"fused_pass: K2 split pipeline, 1M block chain (plans a + b), "
            f"epi_mode {mode}"
            + (" (K6 in the epilogue)" if mode == "inkernel" else ""),
            k6 if mode == "inkernel" else k2, path_launches[mode][0],
            "K6" if mode == "inkernel" else "K2", *chain_ms[mode][:2],
            cost_1m)
    row("circle_table_kernel: K6 generator, one [1024, 1024] table (1M "
        "device-mode plans a + b)", k6, path_launches["device"][1], "K6",
        *gen_ms[N1M][:2], cost_gen[N1M])
    row("circle_table_kernel: K6 generator, one [4096, 4096] table (16M "
        "device-mode plan)", k6, path_launches["16M device"][1], "K6",
        *gen_ms[N16M][:2], cost_gen[N16M])
    row("fused_pass: K2 split pipeline, 512K flat forward + inverse (timed: "
        "forward)", k2, launches_512k, "K2", *k512[:2], cost_512k)
    row("fused_pass: K2 split pipeline, 16M, epi_mode device", k2,
        path_launches["16M device"][0], "K2", *ms16["device"][:2], cost_16m)
    row("fused_pass: K6 in-kernel epilogue, 16M, epi_mode inkernel", k6,
        path_launches["16M inkernel"][0], "K6", *ms16["inkernel"][:2],
        cost_16m)
    row("fused_pass: K3 monolithic schedule, 64k x 64 apply_blocks", k3,
        launches_mono, "K3", *mono_ms[:2], cost_mono)
    row("fused_pass: K3 monolithic schedule, 512K x 2 forward + inverse "
        "(timed: forward)", k3, launches_mono512, "K3", *mono512_ms[:2],
        cost_mono512)
    row("fused_pass: K1/K2 wide, config-2 chain (4 launches)", k1,
        launches_c2, "K1w", *c2_ms[:2], cost_c2)
    row("fused_pass: K2 widening pass (64k unscaled 24-bit)", k2,
        launches_w24, "K2w", *w24_ms[:2], cost_w24)
    row("fused_pass: K5 PallasWideFFTPlan [4096, 1024] (4 plans; timed: "
        "one call)", "intfftk_tpu/ops/pallas_fft.py:742", launches_k5, "K5",
        sum(t[0] for t in k5_ms.values()) / len(k5_ms),
        sum(t[1] for t in k5_ms.values()) / len(k5_ms), cost_k5)
    for payloads in conv_x:
        row(f"fused_pass: K1 raw forward + wide raw inverse, config-4 "
            f"overlap-save convolution, T = {payloads} payloads (4 launches)",
            k1, conv_launches[payloads], "conv", *conv_ms[payloads][:2],
            cost_conv[payloads])
    row(f"chain_kernel: K7 dependent op chain, all ten int32 bodies "
        f"(launches: the probe tool's run; timed: stagemix10 x {K_ROW})",
        "tools/probe_vpu.py:49", probe_launches[0], "K7",
        *probe_ms["K7"][:2], cost_probe["K7"], source=psrc)
    row("copy_kernel: K8 o = x + 1 over 2^28 bytes each way",
        "tools/probe_vpu.py:135", probe_launches[1], "K8",
        *probe_ms["K8"][:2], cost_probe["K8"], source=psrc,
        library_ms=add_ms)
    row(f"chain_kernel: K9 int16 add chain, plain and packed (launches: the "
        f"probe tool's run; timed: add x {K_ROW})", "tools/probe_vpu.py:226",
        probe_launches[2], "K9", *probe_ms["K9"][:2], cost_probe["K9"],
        source=psrc)
    row(f"stage_loop_kernel / stage_once_kernel: K10 per-stage probe, "
        f"{len(probe_stages.STEPS)} steps (launches: the probe tool's run; "
        f"timed: prod_p7 x {K_STAGE})", "tools/probe_stages.py:55",
        stage_launches, "K10", *k10_ms[:2], cost_k10,
        source="intfftk_tpu_torch/csrc/probe_stages.cu")
    row(f"chain_kernel counted by tools/audit_sass.py: K11 compiled-code "
        f"audit (launches: the two counted chains in the probe tool's run; "
        f"timed: mixed7 x {K_ROW})", "tools/audit_mosaic.py:233",
        audit_launches, "K11", *probe_ms["K11"][:2], cost_probe["K11"],
        source=psrc)
    row("product_kernel: P1 spectrum product (launches: one config-4 call "
        "at T = 64 payloads; timed: the product alone on that call's "
        "spectrum)", "intfftk_tpu/parallel/convolve.py:184 (jnp arithmetic "
        "inside the chain's jit, no pallas_call)", product_launches[64],
        "P1", *p1_ms[:2], cost_p1,
        source="intfftk_tpu_torch/csrc/product.cu")
    print(f"ceilings of the bounds on {card}: {ceil[0] / 1e12:.3f} T int "
          f"ops/s (measured in this run), {ceil[1] / 1e12:.3f} TB/s (the "
          f"card's memory clock x bus width); issue limits of the code as "
          f"compiled: {instr_rate / 1e12:.3f} T instructions/s")
    print(json.dumps({"kernels": kernels}))
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
