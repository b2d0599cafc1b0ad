"""Build and load the CUDA kernel library from the sources in ``csrc/``.

The kernels are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain ``extern "C"`` interface, loaded with ``ctypes``:
one ``nvcc -c`` per compilation, all started together, then one link (the
log ends each with its seconds).  A compilation is a source and its macro
definitions: the factor pass's kernels are one source compiled once for
each pair of block types and direction, at the thread counts per CTA of
the tuning rows (``PASS_THREADS``, ``ops/tuning.py``), and the whole
four-step's cluster kernel once for each chain of block types and
direction.  The
build happens at first use, into ``build/torch_kernels/<hash>/`` at the
root of the checkout, keyed on a hash of the sources, the units and the
flags, so a changed source builds anew and an unchanged one loads at once.
``library(threads)`` with a count no row uses builds a variant of the
factor pass alone at that count, into a directory of its own, for the
sweep (``tools/sweep_tuning.py``).  Nothing here runs at import: ``ctypes``
and ``nvcc`` are reached only from ``build()``/``library()``.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path

from ..runtime import trace
from .tuning import (TUNINGS, WHOLE_SHAPES, WIDE_WHOLE_SHAPES,
                     thread_counts)

#: Threads per CTA of the factor pass that the library holds: every count
#: the tuning rows give a pass.
PASS_THREADS = tuple(sorted({t for row in TUNINGS.values()
                             for t in thread_counts(row)}))


def pass_units(threads) -> tuple:
    """The compilations of the factor pass at the thread counts
    ``threads`` (of 128, 256, 512, 1024): its C interface, told them as a
    bit mask (nvcc's -D splits at commas), and its kernels once for each
    pair of block types, direction and thread count."""
    mask = sum(t // 128 for t in threads)
    return (("fused_pass.cu", (f"INTFFT_THREAD_MASK={mask}",)),
            *(("fused_pass_inst.cu", (f"INTFFT_BLOCKS={blocks}",
                                      f"INTFFT_DIR={d}",
                                      f"INTFFT_THREADS={t}"))
              for t in threads for blocks in ("i16", "i32", "i32_i64", "i64")
              for d in ("fwd", "inv")))


#: The chains of block types of the whole four-step's cluster kernel (x,
#: the receive buffer, y): the narrow ones, then the wide ones (wide2,
#: wide1, wide_in).
WHOLE_BLOCKS = ("i16", "i32", "i32_i32_i64", "i32_i64_i64", "i64")
#: The compilations of the whole four-step's cluster kernel: its C
#: interface, and its kernels once for each chain, direction and compiled
#: shape (``tuning.WHOLE_SHAPES`` for the narrow chains,
#: ``WIDE_WHOLE_SHAPES`` for the wide ones).
WHOLE_UNITS = (("fused_whole.cu", ()),
               *(("fused_whole_inst.cu", (f"INTFFT_BLOCKS={blocks}",
                                          f"INTFFT_DIR={d}",
                                          f"INTFFT_SHAPE={s}"))
                 for blocks in WHOLE_BLOCKS for d in ("fwd", "inv")
                 for s in range(len(WIDE_WHOLE_SHAPES if "64" in blocks
                                     else WHOLE_SHAPES))))


#: The compilations of the per-stage probe (K10): its C interface, told
#: the pass's thread counts as a bit mask, and its round-trip and group
#: steps once for each of those counts.
PROBE_STAGE_UNITS = (
    ("probe_stages.cu",
     (f"INTFFT_THREAD_MASK={sum(t // 128 for t in PASS_THREADS)}",)),
    *((source, (f"INTFFT_PROBE_THREADS={t}",)) for t in PASS_THREADS
      for source in ("probe_stages_steps.cu", "probe_stages_groups.cu")))


#: The compilations of the library: (source, macro definitions).
UNITS = (*pass_units(PASS_THREADS), *WHOLE_UNITS, ("probe.cu", ()),
         ("product.cu", ()), *PROBE_STAGE_UNITS)
SOURCES = tuple(dict.fromkeys(source for source, _ in UNITS))
#: Headers the sources include: hashed with them, compiled through them.
HEADERS = ("intfft_arith.cuh", "stage_body.cuh", "fused_pass.cuh",
           "prepared.cuh", "fused_whole.cuh", "probe_stages.cuh")
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


def build(threads: int | None = None) -> tuple[Path, str]:
    """Compile the library unless this source hash is built already; with
    ``threads``, a count outside ``PASS_THREADS``, the factor pass alone at
    that count (a variant).  Returns (path, compiler log); the log is empty
    when nothing was built.  Raises RuntimeError with nvcc's output when
    the build fails."""
    import hashlib
    import subprocess

    units, lib_name = UNITS, LIB_NAME
    if threads is not None:
        units, lib_name = pass_units((threads,)), f"libintfft_pass_t{threads}.so"
    digest = hashlib.sha256(repr((NVCC_FLAGS, units)).encode())
    for name in dict.fromkeys(s for s, _ in units):
        digest.update((CSRC / name).read_bytes())
    for name in HEADERS:
        digest.update((CSRC / name).read_bytes())
    so = BUILD_ROOT / digest.hexdigest()[:16] / lib_name
    if so.exists():
        return so, ""
    so.parent.mkdir(parents=True, exist_ok=True)
    nvcc, pid = find_nvcc(), os.getpid()
    objs = [so.with_name(f".{Path(source).stem}.{i}.{pid}.o")
            for i, (source, _) in enumerate(units)]
    tmp = so.with_name(f".{lib_name}.{pid}.tmp")

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
                for (source, defs), o in zip(units, objs)]
        with ThreadPoolExecutor(len(units)) as pool:
            log = "".join(pool.map(run, cmds, (
                " ".join((source, *defs)) for source, defs in units)))
        log += run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                   "link")
        os.replace(tmp, so)   # atomic: a concurrent build never sees half
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return so, log


@functools.cache
def library(threads: int | None = None):
    """The loaded kernel library, built first if needed; with ``threads``
    outside ``PASS_THREADS``, the variant of the factor pass at that many
    threads per CTA (its C interface alone: ``intfft_fused_pass``,
    ``intfft_prepared_size``, ``intfft_prepare_pass``,
    ``intfft_fused_chain``, ``intfft_pass_attributes``,
    ``intfft_circle_table``, ``intfft_group_split``,
    ``intfft_error_string``).  While a recording is open the build and
    the load are a ``library.load`` span, its note "built" where nvcc ran,
    else "cached"."""
    import ctypes

    if threads in PASS_THREADS:
        return library()
    with trace.span("library.load") as span:
        so, log = build(threads)
        lib = ctypes.CDLL(str(so))
        if span is not None:
            span.note = "built" if log else "cached"
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.intfft_fused_pass.argtypes = ([ptr] * 12 + [i32] * 26
                                     + [ptr, ctypes.POINTER(i32)])
    lib.intfft_fused_pass.restype = i32
    lib.intfft_prepared_size.argtypes = []
    lib.intfft_prepared_size.restype = i32
    lib.intfft_prepare_pass.argtypes = ([i32] * 27
                                        + [ptr, ctypes.POINTER(i32)])
    lib.intfft_prepare_pass.restype = i32
    lib.intfft_fused_chain.argtypes = [ptr, i32, ptr, i32, ptr,
                                       ctypes.POINTER(i32)]
    lib.intfft_fused_chain.restype = i32
    lib.intfft_pass_attributes.argtypes = [i32] * 12 + [ctypes.POINTER(i32)]
    lib.intfft_pass_attributes.restype = i32
    lib.intfft_circle_table.argtypes = ([ptr] * 4 + [i32] * 8
                                        + [ptr, ctypes.POINTER(i32)])
    lib.intfft_circle_table.restype = i32
    lib.intfft_group_split.argtypes = [i32, i32] + [ctypes.POINTER(i32)] * 2
    lib.intfft_group_split.restype = i32
    lib.intfft_error_string.argtypes = [i32]
    lib.intfft_error_string.restype = ctypes.c_char_p
    if threads is not None:
        return lib
    lib.intfft_prepare_whole.argtypes = ([i32] * 21
                                         + [ptr, ctypes.POINTER(i32)])
    lib.intfft_prepare_whole.restype = i32
    lib.intfft_query_whole.argtypes = [i32] * 11 + [ctypes.POINTER(i32)]
    lib.intfft_query_whole.restype = i32
    i64 = ctypes.c_longlong
    lib.intfft_probe_chain.argtypes = [ptr, ptr, i64] + [i32] * 4 + [ptr]
    lib.intfft_probe_chain.restype = i32
    lib.intfft_probe_copy.argtypes = [ptr, ptr, i64, i32, ptr]
    lib.intfft_probe_copy.restype = i32
    lib.intfft_probe_cta_elems.argtypes = []
    lib.intfft_probe_cta_elems.restype = i32
    lib.intfft_probe_packed_block.argtypes = []
    lib.intfft_probe_packed_block.restype = i32
    lib.intfft_probe_mem_peak.argtypes = [i32]
    lib.intfft_probe_mem_peak.restype = i64
    lib.intfft_spectrum_product.argtypes = ([ptr] * 6 + [i64, i64]
                                            + [i32] * 6 + [ptr])
    lib.intfft_spectrum_product.restype = i32
    lib.intfft_stage_probe.argtypes = [ptr] * 8 + [i32] * 15 + [ptr]
    lib.intfft_stage_probe.restype = i32
    lib.intfft_stage_probe_geometry.argtypes = [i32] * 8 + [
        ctypes.POINTER(i32)]
    lib.intfft_stage_probe_geometry.restype = i32
    lib.intfft_stage_probe_tile.argtypes = [i32] * 4 + [ctypes.POINTER(i32)]
    lib.intfft_stage_probe_tile.restype = i32
    return lib


def check(lib, err: int, what: str):
    """Raise when a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.intfft_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
