"""ctypes bindings for the native C++ exact-integer engine.

``native/intfft_golden.cpp`` implements the identical bit-level semantics
as ``golden.int_model`` (both mirror the reference RTL); this module loads
it, auto-building with ``make`` on first use.  A copy of
``intfftk_tpu/runtime/native.py`` over the same library in the
repository's ``native/``, taking the port's ``FFTConfig``.  It serves as:

* an independent second oracle (C++ vs NumPy vs JAX triple agreement,
  tests/test_native.py, tests/test_torch_utils.py),
* the fast host reference for scripted validation of big batches,
* the compute core behind the streaming host pipeline.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from ..config import FFTConfig

#: twiddle_gen string -> the C engine's enum (intfft_golden.cpp)
_GEN_CODE = {"auto": 0, "taylor_old": 0, "rom": 1, "taylor_new": 2}

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libintfft_golden.so")
_lock = threading.Lock()
_lib = None


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, "-s"], check=True,
                       capture_output=True, timeout=120)
        return True
    except (subprocess.SubprocessError, FileNotFoundError):
        return False


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        # always run make: its dependency rule rebuilds a stale .so
        # (source newer than the library), no-op otherwise
        if not _build() and not os.path.exists(_LIB_PATH):
            return None
        lib = ctypes.CDLL(_LIB_PATH)
        lib.intfft_exec.restype = ctypes.c_int
        lib.intfft_exec.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.intfft_stage_twiddles.restype = ctypes.c_int
        lib.intfft_stage_twiddles.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class NativeGolden:
    """Exact integer transform executed by the native engine."""

    def __init__(self):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native engine unavailable (g++/make missing?)")

    def fft(self, x_re, x_im, cfg: FFTConfig, inverse: bool = False):
        """[..., n] integer arrays -> (re, im) int64, same contract as
        ``golden.fft_int`` (natural in/out, unnormalized inverse)."""
        xr = np.ascontiguousarray(np.asarray(x_re, dtype=np.int64))
        xi = np.ascontiguousarray(np.asarray(x_im, dtype=np.int64))
        if xr.shape[-1] != cfg.n:
            raise ValueError(f"last dim {xr.shape[-1]} != n={cfg.n}")
        out_r, out_i = xr.copy(), xi.copy()
        batch = int(np.prod(out_r.shape[:-1], dtype=np.int64))
        rc = self._lib.intfft_exec(
            _ptr(out_r), _ptr(out_i), batch, cfg.n,
            1 if cfg.mode == "unscaled" else 0,
            1 if cfg.rounding == "round" else 0,
            cfg.data_width, cfg.twiddle_width,
            _GEN_CODE[cfg.twiddle_gen],
            1 if inverse else 0, 1 if cfg.bypass_fly else 0)
        if rc != 0:
            raise ValueError(f"intfft_exec failed rc={rc} "
                             f"(rc=4: output width > 63, use golden.fft_int)")
        return out_r, out_i

    def stage_twiddles(self, p: int, width: int, twiddle_gen: str = "auto"):
        n = 1 << p
        re = np.zeros(n, dtype=np.int64)
        im = np.zeros(n, dtype=np.int64)
        rc = self._lib.intfft_stage_twiddles(
            _ptr(re), _ptr(im), p, width, _GEN_CODE[twiddle_gen])
        if rc != 0:
            raise ValueError(f"stage_twiddles failed rc={rc}")
        return re, im
