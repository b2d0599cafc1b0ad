"""A/B of two checkouts of the PyTorch/CUDA port on one card: the 64k headline, the
channelizer and the 1M block chain of each tree, timed in fresh processes
in turns (A, B, B, A), beside a digest of the headline kernel's compiled
code, so that a change to a shared source (a stage body moved into a
header, a launch loop) can be shown not to move the paths it does not mean
to move.

A development script, not part of the package.  Usage, on a machine with
the card:

    python tools/ab_torch_paths.py ROOT_A ROOT_B

Each process imports ``intfftk_tpu_torch`` from the root it is given (the
other tree need not hold this file), builds that tree's kernels, and prints
one JSON line: per path the device ms of one call (CUDA events over chained
calls, four readings; the headline again after the other paths have loaded
the card, each time with the number of distinct output buffers its chained
calls cycled through and the span of their addresses), and the headline kernel's instruction count, its butterfly
loop's, and a hash of its opcode sequence, read with the ``audit_sass`` of
the tree that holds this file.  Compare numbers only within one run of this tool.
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
    from intfftk_tpu_torch.ops.fused_fft import LargeFFTPlan, fused_pass
    from intfftk_tpu_torch.parallel import Channelizer

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(5)

    def data(shape, dtype):
        return [torch.as_tensor(rng.integers(-(1 << 15), 1 << 15, shape),
                                dtype=dtype, device=dev) for _ in range(2)]

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
    out = {"root": root,
           "64k_fresh": four(plan.apply_blocks, x64, 50),
           "64k_fresh_buffers": placement(plan.apply_blocks, x64, 50),
           "64k_pass1": four(pass1, x64, 50),
           "64k_pass2": four(pass2, x64, 50),
           "channelizer_cn": four(chz, xch, 20),
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
    span, _ = au.butterfly_loop(ins)
    out["headline_kernel"] = {
        "instructions": len(ins),
        "butterfly_loop": sum(span[0] <= i.addr <= span[1] for i in ins),
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
