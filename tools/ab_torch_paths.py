"""A/B of two checkouts of the PyTorch/CUDA port on one card: the 64k
headline and its two passes, the channelizer (``cn``, ``nc``), the 1M block
chain, 512K at batch 8, 16M, the int64 single-pass engine (K5), the 64k
24-bit widening path, overlap-save convolution (config 4) at 64 and 4
payloads and the config-2 chain of each tree, timed
in fresh processes in turns (A, B, B, A), beside a digest of the headline
kernel's compiled code, so that a change to a shared source (a redesigned
kernel, a stage body moved into a header, a launch loop) can be read
against its parent, and shown not to move the paths it does not mean to
move.

A development script, not part of the package.  Usage, on a machine with
the card:

    python tools/ab_torch_paths.py ROOT_A ROOT_B

Each process imports ``intfftk_tpu_torch`` from the root it is given (the
other tree need not hold this file), builds that tree's kernels, and prints
one JSON line: the seconds its kernels took to build, per path the device ms of one call (CUDA events over chained
calls, four readings; the headline again after the other paths have loaded
the card, each time with the number of distinct output buffers its chained
calls cycled through and the span of their addresses; the paths the host
paces, the convolution at 4 payloads and the config-2 chain, as [device ms,
host ms to issue one call] pairs), and the headline kernel's instruction
count and a hash of its opcode sequence, read with the ``audit_sass`` of
the tree that holds this file.  Compare numbers only within one run of
this tool.
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

    def paced(fn, x, calls):
        """[device ms, host ms to issue] per call, ``READINGS`` times."""
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
            out.append([round(start.elapsed_time(end) / calls, 4),
                        round(host * 1e3 / calls, 4)])
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
           "1m_chain": four(lambda a, b: b1m.apply_blocks(
               *a1m.apply_blocks(a, b)), x1m, 20),
           "64k_loaded": four(plan.apply_blocks, x64, 50),
           "64k_loaded_buffers": placement(plan.apply_blocks, x64, 50)}
    # the compiled headline kernel, read with this tree's parser
    spec = importlib.util.spec_from_file_location(
        "ab_audit_sass", HERE.parents[1] / "intfftk_tpu_torch" / "tools"
        / "audit_sass.py")
    au = importlib.util.module_from_spec(spec)
    sys.modules["ab_audit_sass"] = au
    spec.loader.exec_module(au)
    so, _ = _build.build()
    sass = au.parse_sass(au.dump_sass(so))
    ins = sass[au.find_function(sass, au.pass_pattern(False))]
    out["headline_kernel"] = {
        "instructions": len(ins),
        "opcodes_sorted_sha1": hashlib.sha1(" ".join(sorted(
            i.opcode for i in ins)).encode()).hexdigest()[:12],
        "opcodes_in_order_sha1": hashlib.sha1(" ".join(
            i.opcode for i in ins).encode()).hexdigest()[:12]}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 2 and argv[0] == "--read":
        print(json.dumps(_read(argv[1])), flush=True)
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = argv
    for root in (a, b, b, a):
        subprocess.run([sys.executable, str(HERE), "--read", root],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
