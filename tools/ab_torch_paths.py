"""A/B of two checkouts of the PyTorch/CUDA port on one card: the 64k
headline and its two passes, the channelizer (``cn``, ``nc``), the 1M block
chain, 512K at batch 8, 16M, the int64 single-pass engine (K5), the 64k
24-bit widening path, overlap-save convolution (config 4) at 64 and 4
payloads, the config-2 chain, the monolithic 64k and the host's time to
issue one ``fused_pass`` of each tree, timed
in fresh processes in turns (A, B, B, A), beside a digest of the headline
kernel's compiled code, so that a change to a shared source (a redesigned
kernel, a stage body moved into a header, a launch loop) can be read
against its parent, and shown not to move the paths it does not mean to
move.

A development script, not part of the package.  Usage, on a machine with
the card:

    python tools/ab_torch_paths.py ROOT_A ROOT_B [--rounds N]

Each process imports ``intfftk_tpu_torch`` from the root it is given (the
other tree need not hold this file), builds that tree's kernels, and prints
one JSON line: the seconds its kernels took to build, per path the device ms of one call (CUDA events over chained
calls, four readings; the headline again after the other paths have loaded
the card, each time with the number of distinct output buffers its chained
calls cycled through and the span of their addresses; the paths the host
paces, the convolution at 4 payloads, the config-2 chain, one
``fused_pass`` (the 64k headline's second pass, issued as the plan issues
it), the headline's ``apply_blocks``, the 64k raw roundtrip at batch 8,
monolithic 512K x 2 and config 5 (``FourStepPlan``, 1M at batch 2, over
NCCL on a mesh of one rank), as [device ms, host ms to issue one call,
captured ms] triples, the last the card's own time for one call: a CUDA
graph of the chained calls, replayed once; none for config 5, whose turns
are collectives), and the headline
kernel's instruction
count and a hash of its opcode sequence, read with the ``audit_sass`` of
the tree that holds this file.  ``--rounds N`` runs the four processes N
times (A, B, B, A, A, B, B, A, ...); the last line is a summary: per
reading the least value each tree showed (a hiccup of the host only adds
time) and B's over A's.  Compare numbers only within one run of this
tool.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve()
READINGS = 4


def _read(root: str) -> dict:
    """The readings of the tree at ``root``, taken in this process."""
    import dataclasses
    import hashlib
    import importlib.util

    sys.path.insert(0, root)
    import numpy as np
    import torch
    from intfftk_tpu_torch.config import FFTConfig
    from intfftk_tpu_torch.ops import _build
    import time

    from intfftk_tpu_torch.golden import make_conv_spec
    from intfftk_tpu_torch.ops.fused_fft import LargeFFTPlan, fused_pass
    from intfftk_tpu_torch.ops.intmath import spectrum_product
    from intfftk_tpu_torch.ops.single_pass import PallasWideFFTPlan
    from intfftk_tpu_torch.parallel import Channelizer, OverlapSaveConv

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(5)
    t0 = time.perf_counter()
    _build.library()
    build_s = round(time.perf_counter() - t0, 2)

    def data(shape, dtype, bits=16):
        lim = 1 << (bits - 1)
        return [torch.as_tensor(rng.integers(-lim, lim, shape), dtype=dtype,
                                device=dev) for _ in range(2)]

    def ms(fn, x, calls):
        a, b = x
        for _ in range(3):
            a, b = fn(a, b)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            a, b = fn(a, b)
        end.record()
        end.synchronize()
        return round(start.elapsed_time(end) / calls, 4)

    def four(fn, x, calls):
        return [ms(fn, x, calls) for _ in range(READINGS)]

    def fixed(fn):
        """fn on one fixed input, for a path whose output is no input."""
        return lambda a, b: (fn(a, b), (a, b))[1]

    def graph(fn, x, calls):
        """One CUDA graph of ``calls`` chained calls of fn on x (torch's
        own ``torch.cuda.graph``, so that a tree without the port's
        ``runtime.graph`` is read the same way), or None where the tree's
        path cannot be captured."""
        a, b = x
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(a, b)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(g):
                for _ in range(calls):
                    a, b = fn(a, b)
        except RuntimeError:
            return None
        return g

    def paced(fn, x, calls, capture=True):
        """[device ms, host ms to issue, captured ms] per call, ``READINGS``
        times: the last is the card's own time for the call, one replay of
        a graph of ``calls`` chained calls over ``calls`` (None where the
        path cannot be captured, or ``capture`` is off)."""
        g = graph(fn, x, calls) if capture else None
        out = []
        for _ in range(READINGS):
            for _ in range(3):
                fn(*x)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(*x)
            host = time.perf_counter() - t0
            end.record()
            end.synchronize()
            reading = [round(start.elapsed_time(end) / calls, 4),
                       round(host * 1e3 / calls, 4), None]
            if g is not None:
                start.record()
                g.replay()
                end.record()
                end.synchronize()
                reading[2] = round(start.elapsed_time(end) / calls, 4)
            out.append(reading)
        return out

    def placement(fn, x, calls):
        """[distinct output buffers of the chained calls, the MiB their
        addresses span]: where the allocator puts a path's working set."""
        seen = set()
        a, b = x
        for _ in range(calls):
            a, b = fn(a, b)
            seen.update((a.data_ptr(), b.data_ptr()))
        torch.cuda.synchronize()
        return [len(seen), (max(seen) - min(seen)) >> 20]

    kw = dict(mode="scaled", rounding="round", data_width=16,
              twiddle_width=16)
    plan = LargeFFTPlan(FFTConfig(n=1 << 16, **kw), device=dev)
    x64 = data((64, 256, 256), torch.int16)
    pass1 = lambda a, b: fused_pass(a, b, plan.cfg1, (plan.w1r, plan.w1i),
                                    epi=(plan.er, plan.ei),
                                    transpose_out=True)
    pass2 = lambda a, b: fused_pass(a, b, plan.cfg2, (plan.w2r, plan.w2i),
                                    transpose_out=False)
    # the second pass as the plan issues it (with its launch geometry,
    # where the tree has one)
    cfg2, kw2 = plan.passes()[1]
    plan_pass2 = lambda a, b: fused_pass(a, b, cfg2, **kw2)
    mono = LargeFFTPlan(FFTConfig(n=1 << 16, **kw), schedule="monolithic",
                        device=dev)
    chz = Channelizer(FFTConfig(n=4096, mode="scaled", rounding="round"),
                      layout="cn", device=dev)
    xch = data((4096, 4096), torch.int32)
    a1m = LargeFFTPlan(FFTConfig(n=1 << 20, **kw), device=dev)
    b1m = LargeFFTPlan(FFTConfig(n=1 << 20, **kw), a1m.n2, a1m.n1,
                       device=dev)
    x1m = data((4, 1024, 1024), torch.int16)
    p512 = LargeFFTPlan(FFTConfig(n=1 << 19, **kw), device=dev)
    x512 = data((8,) + tuple(p512.block_in_shape), torch.int16)
    nc = Channelizer(FFTConfig(n=4096, mode="scaled", rounding="round"),
                     layout="nc", device=dev)
    p16m = LargeFFTPlan(FFTConfig(n=1 << 24, **kw), device=dev)
    x16m = data((1, 4096, 4096), torch.int16)
    k5 = PallasWideFFTPlan(FFTConfig(n=4096, mode="unscaled", data_width=32,
                                     twiddle_width=16), device=dev)
    x5 = data((4096, 1024), torch.int64, 32)
    # 64k unscaled 24-bit: the widening pass, then the int64 tile at m = 256
    w24 = LargeFFTPlan(FFTConfig(n=1 << 16, mode="unscaled", data_width=24,
                                 twiddle_width=16), device=dev)
    x24 = data((64,) + tuple(w24.block_in_shape), torch.int32, 24)
    # config 4: 8193 taps in 64k blocks, a 44-bit product
    spec = make_conv_spec(n=1 << 16, taps_len=(1 << 13) + 1, twiddle_width=16,
                          max_product_width=44, max_spectrum_width=25)
    taps = np.random.default_rng(1).integers(-(1 << 13), 1 << 13,
                                             spec.taps_len)
    conv = OverlapSaveConv(spec, taps, np.zeros_like(taps), device=dev)
    xconv = {t: data((t * spec.payload,), torch.int32, 14) for t in (64, 4)}
    # config 2: the raw unscaled forward to 48 bits, the unity 25-bit
    # spectrum product, the raw scaled/round inverse
    c2 = FFTConfig(n=1 << 16, mode="unscaled", data_width=32,
                   twiddle_width=20)
    f2 = LargeFFTPlan(c2, order="raw", device=dev)
    i2 = LargeFFTPlan(FFTConfig(n=1 << 16, mode="scaled", rounding="round",
                                data_width=c2.output_width,
                                twiddle_width=20),
                      f2.n2, f2.n1, inverse=True, order="raw", device=dev)
    unity = (torch.full(f2.block_out_shape, 1 << 23, dtype=torch.int32,
                        device=dev),
             torch.zeros(f2.block_out_shape, dtype=torch.int32, device=dev))

    def c2_chain(a, b):
        y = spectrum_product(*f2.apply_blocks(a, b), *unity, 23,
                             c2.output_width, 25, torch.int64)
        return i2.apply_blocks(*y)

    x2 = data((8,) + tuple(f2.block_in_shape), torch.int32, 28)
    # the 64k raw roundtrip at batch 8 and monolithic 512K x 2
    rf = LargeFFTPlan(FFTConfig(n=1 << 16, **kw), order="raw", device=dev)
    ri = LargeFFTPlan(dataclasses.replace(rf.cfg,
                                          data_width=rf.cfg.output_width),
                      rf.n2, rf.n1, inverse=True, order="raw", device=dev)
    xrt = data((8,) + tuple(rf.block_in_shape), torch.int16)
    m512 = LargeFFTPlan(FFTConfig(n=1 << 19, **kw), schedule="monolithic",
                        device=dev)
    xm512 = data((2,) + tuple(m512.block_in_shape), torch.int16)
    # config 5: FourStepPlan over NCCL on a mesh of one rank (its turns are
    # collectives: not captured)
    import tempfile

    import torch.distributed as dist
    from intfftk_tpu_torch.golden import random_stimulus
    from intfftk_tpu_torch.parallel import (FourStepPlan, initialize_multihost,
                                            pod_mesh)

    store = tempfile.mkdtemp()
    initialize_multihost(f"file://{store}/store", 1, 0)
    p5 = FourStepPlan(FFTConfig(n=1 << 20, **kw), 1024, 1024, pod_mesh(1, 1))
    x5c = [p5.shard(v).int()
           for v in random_stimulus(1 << 20, 15, seed=31, batch=(2,))]
    out = {"root": root, "build_s": build_s,
           "64k_fresh": four(plan.apply_blocks, x64, 50),
           "64k_fresh_buffers": placement(plan.apply_blocks, x64, 50),
           "64k_pass1": four(pass1, x64, 50),
           "64k_pass2": four(pass2, x64, 50),
           "channelizer_cn": four(chz, xch, 20),
           "channelizer_nc": four(nc, [t.T.contiguous() for t in xch], 20),
           "512k": four(fixed(p512.apply_blocks), x512, 20),
           "16m": four(p16m.apply_blocks, x16m, 10),
           "k5_int64": four(fixed(k5), x5, 20),
           "64k_24bit_wide": four(fixed(w24.apply_blocks), x24, 20),
           "config4_t64": four(fixed(conv), xconv[64], 20),
           "config4_t4_device_host": paced(conv, xconv[4], 20),
           "config2_chain_device_host": paced(c2_chain, x2, 50),
           "fused_pass_device_host": paced(plan_pass2, x64, 50),
           "64k_device_host": paced(plan.apply_blocks, x64, 50),
           "roundtrip_device_host": paced(lambda a, b: ri.apply_blocks(
               *rf.apply_blocks(a, b)), xrt, 50),
           "monolithic_512k_x2_device_host": paced(fixed(m512.apply_blocks),
                                                   xm512, 50),
           "config5_device_host": paced(p5, x5c, 20, capture=False),
           "monolithic_64k": four(mono.apply_blocks, x64, 50),
           "1m_chain": four(lambda a, b: b1m.apply_blocks(
               *a1m.apply_blocks(a, b)), x1m, 20),
           "64k_loaded": four(plan.apply_blocks, x64, 50),
           "64k_loaded_buffers": placement(plan.apply_blocks, x64, 50)}
    dist.destroy_process_group()
    # the compiled headline kernel, read with this tree's parser
    spec = importlib.util.spec_from_file_location(
        "ab_audit_sass", HERE.parents[1] / "intfftk_tpu_torch" / "tools"
        / "audit_sass.py")
    au = importlib.util.module_from_spec(spec)
    sys.modules["ab_audit_sass"] = au
    spec.loader.exec_module(au)
    so, _ = _build.build()
    sass = au.parse_sass(au.dump_sass(so))
    try:    # the thread count of the tree's headline pass
        from intfftk_tpu_torch.ops.tuning import TUNINGS, pass_geometry

        threads = pass_geometry(TUNINGS["sm_90"], 256, 256, False)["threads"]
    except ImportError:     # a tree before the tuning layer: one count
        threads = 256
    ins = sass[au.find_function(sass, au.pass_pattern(False, threads))]
    out["headline_kernel"] = {
        "instructions": len(ins),
        "opcodes_sorted_sha1": hashlib.sha1(" ".join(sorted(
            i.opcode for i in ins)).encode()).hexdigest()[:12],
        "opcodes_in_order_sha1": hashlib.sha1(" ".join(
            i.opcode for i in ins).encode()).hexdigest()[:12]}
    return out


def summary(a: list[dict], b: list[dict]) -> dict:
    """Per reading, the least value each tree showed over all its processes
    (a hiccup of the host only adds time; for [device, host, captured]
    triples, each of the three), and B's over A's."""
    out = {}
    for key, value in a[0].items():
        if not isinstance(value, list) or key.endswith("_buffers"):
            continue
        if isinstance(value[0], list):
            least = [[min((v[i] for r in rs for v in r[key]
                           if v[i] is not None), default=None)
                      for i in range(len(value[0]))] for rs in (a, b)]
            ratio = [round(y / x, 4) if x and y else None
                     for x, y in zip(*least)]
        else:
            least = [min(v for r in rs for v in r[key]) for rs in (a, b)]
            ratio = round(least[1] / least[0], 4)
        out[key] = {"a": least[0], "b": least[1], "b_over_a": ratio}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 2 and argv[0] == "--read":
        print(json.dumps(_read(argv[1])), flush=True)
        return 0
    rounds = 1
    if len(argv) == 4 and argv[2] == "--rounds":
        rounds, argv = int(argv[3]), argv[:2]
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = argv
    seen = {a: [], b: []}
    for root in (a, b, b, a) * rounds:
        proc = subprocess.run([sys.executable, str(HERE), "--read", root],
                              check=True, stdout=subprocess.PIPE, text=True)
        print(proc.stdout, end="", flush=True)
        seen[root].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(json.dumps({"summary": summary(seen[a], seen[b])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
