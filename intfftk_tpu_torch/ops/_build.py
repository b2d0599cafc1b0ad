"""Build and load the CUDA kernel library from the sources in ``csrc/``.

The kernels are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain ``extern "C"`` interface, loaded with ``ctypes``:
one ``nvcc -c`` per source, all started together, then one link.  The
build happens at first use, into ``build/torch_kernels/<hash>/`` at the
root of the checkout, keyed on a hash of the sources and the flags, so a
changed source builds anew and an unchanged one loads at once.  Nothing
here runs at import: ``ctypes`` and ``nvcc`` are reached only from
``build()``/``library()``.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path

SOURCES = ("fused_pass.cu", "probe.cu", "product.cu", "probe_stages.cu")
#: Headers the sources include: hashed with them, compiled through them.
HEADERS = ("intfft_arith.cuh", "stage_body.cuh")
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libintfft_torch.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    import shutil

    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> tuple[Path, str]:
    """Compile the library unless this source hash is built already.
    Returns (path, compiler log); the log is empty when nothing was built.
    Raises RuntimeError with nvcc's output when the build fails."""
    import hashlib
    import subprocess

    srcs = [CSRC / s for s in SOURCES]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + [CSRC / h for h in HEADERS]:
        digest.update(s.read_bytes())
    so = BUILD_ROOT / digest.hexdigest()[:16] / LIB_NAME
    if so.exists():
        return so, ""
    so.parent.mkdir(parents=True, exist_ok=True)
    nvcc, pid = find_nvcc(), os.getpid()
    objs = [so.with_name(f".{s.stem}.{pid}.o") for s in srcs]
    tmp = so.with_name(f".{LIB_NAME}.{pid}.tmp")

    def start(cmd):
        return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)

    def finish(cmd, proc, out):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
        return out

    try:
        # one compile per source, all started together, then the link
        jobs = [start([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)])
                for s, o in zip(srcs, objs)]
        outs = [proc.communicate()[0] for _, proc in jobs]
        log = "".join(finish(*job, out) for job, out in zip(jobs, outs))
        link = start([nvcc, "-shared", "-o", str(tmp), *map(str, objs)])
        log += finish(*link, link[1].communicate()[0])
        os.replace(tmp, so)   # atomic: a concurrent build never sees half
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return so, log


@functools.cache
def library():
    """The loaded kernel library, built first if needed."""
    import ctypes

    so, _ = build()
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.intfft_fused_pass.argtypes = ([ptr] * 12 + [i32] * 19
                                     + [ptr, ctypes.POINTER(i32)])
    lib.intfft_fused_pass.restype = i32
    lib.intfft_circle_table.argtypes = [ptr] * 4 + [i32] * 8 + [ptr]
    lib.intfft_circle_table.restype = i32
    i64 = ctypes.c_longlong
    lib.intfft_probe_chain.argtypes = [ptr, ptr, i64] + [i32] * 4 + [ptr]
    lib.intfft_probe_chain.restype = i32
    lib.intfft_probe_copy.argtypes = [ptr, ptr, i64, i32, i32, ptr]
    lib.intfft_probe_copy.restype = i32
    lib.intfft_probe_cta_elems.argtypes = []
    lib.intfft_probe_cta_elems.restype = i32
    lib.intfft_probe_mem_peak.argtypes = [i32]
    lib.intfft_probe_mem_peak.restype = i64
    lib.intfft_spectrum_product.argtypes = ([ptr] * 6 + [i64, i64]
                                            + [i32] * 6 + [ptr])
    lib.intfft_spectrum_product.restype = i32
    lib.intfft_stage_probe.argtypes = [ptr] * 8 + [i32] * 12 + [ptr]
    lib.intfft_stage_probe.restype = i32
    lib.intfft_stage_probe_geometry.argtypes = [i32] * 5 + [
        ctypes.POINTER(i32)] * 2
    lib.intfft_stage_probe_geometry.restype = i32
    lib.intfft_error_string.argtypes = [i32]
    lib.intfft_error_string.restype = ctypes.c_char_p
    return lib


def check(lib, err: int, what: str):
    """Raise when a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.intfft_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
