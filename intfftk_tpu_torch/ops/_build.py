"""Build and load the CUDA kernel library from the sources in ``csrc/``.

The kernels are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain ``extern "C"`` interface, loaded with ``ctypes``:
one ``nvcc -c`` per compilation, all started together, then one link (the
log ends each with its seconds).  A compilation is a source and its macro
definitions: the factor pass's kernels are one source compiled once for
each pair of block types and direction.  The build happens at first use,
into ``build/torch_kernels/<hash>/`` at the root of the checkout, keyed on a hash of the sources and the flags, so a
changed source builds anew and an unchanged one loads at once.  Nothing
here runs at import: ``ctypes`` and ``nvcc`` are reached only from
``build()``/``library()``.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path

#: The compilations: (source, macro definitions).
UNITS = (
    ("fused_pass.cu", ()),
    *(("fused_pass_inst.cu", (f"INTFFT_BLOCKS={blocks}", f"INTFFT_DIR={d}"))
      for blocks in ("i16", "i32", "i32_i64", "i64") for d in ("fwd", "inv")),
    ("probe.cu", ()), ("product.cu", ()), ("probe_stages.cu", ()),
    ("probe_stages_groups.cu", ()))
SOURCES = tuple(dict.fromkeys(source for source, _ in UNITS))
#: Headers the sources include: hashed with them, compiled through them.
HEADERS = ("intfft_arith.cuh", "stage_body.cuh", "fused_pass.cuh",
           "probe_stages.cuh")
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

    digest = hashlib.sha256(repr((NVCC_FLAGS, UNITS)).encode())
    for name in SOURCES + HEADERS:
        digest.update((CSRC / name).read_bytes())
    so = BUILD_ROOT / digest.hexdigest()[:16] / LIB_NAME
    if so.exists():
        return so, ""
    so.parent.mkdir(parents=True, exist_ok=True)
    nvcc, pid = find_nvcc(), os.getpid()
    objs = [so.with_name(f".{Path(source).stem}.{i}.{pid}.o")
            for i, (source, _) in enumerate(UNITS)]
    tmp = so.with_name(f".{LIB_NAME}.{pid}.tmp")

    def run(cmd, what):
        import time

        start = time.monotonic()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}")
        return f"{proc.stdout}nvcc {what}: {time.monotonic() - start:.1f} s\n"

    try:
        # one compile per unit, all started together, then the link
        from concurrent.futures import ThreadPoolExecutor

        cmds = [[nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in defs), "-c", "-o",
                 str(o), str(CSRC / source)]
                for (source, defs), o in zip(UNITS, objs)]
        with ThreadPoolExecutor(len(UNITS)) as pool:
            log = "".join(pool.map(run, cmds, (
                " ".join((source, *defs)) for source, defs in UNITS)))
        log += run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                   "link")
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
    lib.intfft_probe_copy.argtypes = [ptr, ptr, i64, i32, ptr]
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
    lib.intfft_group_split.argtypes = [i32, i32] + [ctypes.POINTER(i32)] * 2
    lib.intfft_group_split.restype = i32
    lib.intfft_error_string.argtypes = [i32]
    lib.intfft_error_string.restype = ctypes.c_char_p
    return lib


def check(lib, err: int, what: str):
    """Raise when a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.intfft_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
