"""Forms of the copy probe (K8, ``o = x + 1`` over 2^28 bytes each way) timed
beside ``torch.add`` and the port's ``probe_copy`` on one card: 1, 2, 4 or 8
16-byte loads hoisted before a thread's first store, plain accesses or the
streaming hints ``__ldcs``/``__stcs``, and a grid-stride loop on 8, 16 or 32
CTAs per SM or a grid that covers the array (0).  The reading behind the
form ``csrc/probe.cu`` keeps.

A development script, not part of the package.  Usage, on a machine with
the card, from the root of the checkout:

    python tools/ab_copy_forms.py

It compiles the source below with nvcc into ``build/``, checks every form
against ``x + 1``, times ``torch.add``, ``probe_copy``, every form, and
``torch.add``, ``probe_copy`` again, twice over, and prints the forms in
order of their best time (ms per launch, CUDA events over 40 launches).
"""

from __future__ import annotations

import ctypes
import itertools
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NBYTES = 1 << 28
SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
constexpr int kThreads = 256;
template <int U, int HINT>
__global__ void __launch_bounds__(kThreads)
copy_form(const int4* __restrict__ x, int4* __restrict__ y, size_t n4) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads * U;
  for (size_t i0 = static_cast<size_t>(blockIdx.x) * kThreads * U +
                   threadIdx.x;
       i0 < n4; i0 += stride) {
    int4 v[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const size_t i = i0 + static_cast<size_t>(j) * kThreads;
      if (i < n4) v[j] = HINT ? __ldcs(x + i) : x[i];
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const size_t i = i0 + static_cast<size_t>(j) * kThreads;
      if (i < n4) {
        v[j].x += 1; v[j].y += 1; v[j].z += 1; v[j].w += 1;
        if (HINT) __stcs(y + i, v[j]); else y[i] = v[j];
      }
    }
  }
}
template <int U, int HINT>
int go(const void* x, void* y, long long n4, int ctas, cudaStream_t s) {
  if (ctas <= 0) ctas = (int)((n4 + kThreads * U - 1) / (kThreads * U));
  copy_form<U, HINT><<<ctas, kThreads, 0, s>>>((const int4*)x, (int4*)y,
                                               (size_t)n4);
  return (int)cudaGetLastError();
}
extern "C" int copy_form_launch(const void* x, void* y, long long n_words,
                                int unroll, int hint, int ctas,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n4 = n_words / 4;
#define FORM(U) \
  if (unroll == U) \
    return hint ? go<U, 1>(x, y, n4, ctas, s) : go<U, 0>(x, y, n4, ctas, s);
  FORM(1) FORM(2) FORM(4) FORM(8)
  return 1;
}
"""


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    from intfftk_tpu_torch.ops import _build
    from intfftk_tpu_torch.tools import probe_vpu

    build = ROOT / "build" / "ab_copy_forms"
    build.mkdir(parents=True, exist_ok=True)
    (build / "copy_forms.cu").write_text(SOURCE)
    so = build / "libcopy_forms.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS[:-2], "-shared",
                    "-o", str(so), str(build / "copy_forms.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    lib.copy_form_launch.argtypes = ([ctypes.c_void_p] * 2
                                     + [ctypes.c_longlong] + [ctypes.c_int] * 3
                                     + [ctypes.c_void_p])
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    x = torch.randint(-1000, 1000, (NBYTES // 4,), dtype=torch.int32,
                      device=dev)
    y = torch.empty_like(x)

    def form(unroll, hint, ctas_per_sm):
        err = lib.copy_form_launch(
            x.data_ptr(), y.data_ptr(), x.numel(), unroll, hint,
            ctas_per_sm * sms, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    def ms(fn, calls=40):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return round(start.elapsed_time(end) / calls, 4)

    def yardsticks():
        print(f"torch.add {ms(lambda: torch.add(x, 1, out=y))} ms, "
              f"probe_copy {ms(lambda: probe_vpu.probe_copy(x, out=y))} ms",
              flush=True)

    print(torch.cuda.get_device_name(0), subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    times: dict = {}
    for turn in range(2):
        yardsticks()
        for key in itertools.product((1, 2, 4, 8), (0, 1), (8, 16, 32, 0)):
            form(*key)
            torch.cuda.synchronize()
            if turn == 0 and not torch.equal(y, x + 1):
                raise RuntimeError(f"form {key} differs from x + 1")
            times.setdefault(key, []).append(ms(lambda: form(*key)))
        yardsticks()
    for (unroll, hint, ctas), t in sorted(times.items(),
                                          key=lambda kv: min(kv[1])):
        print(f"loads in flight {unroll}, streaming hints {hint}, CTAs per "
              f"SM {ctas or 'covering grid'}: {t}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
