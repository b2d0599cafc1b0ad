"""Float golden model mirroring the reference's staged two-lane dataflow.

This is a structural port of the reference's executable spec
``reference/math/fn_radix2.m`` — the two-lane arrays, per-stage
butterfly, per-stage cross-commutation, twiddle replication and final
interleave + bit-reversal — kept lane-accurate so the permutation algebra of
the TPU kernels can be validated against it.  It is itself validated against
``numpy.fft`` (the role ``math/test_fft_radix2.m:89-110`` plays for Octave's
builtin fft).

Lane convention (``fn_radix2.m:152-160``): lane A holds x[0 : N/2], lane B
holds x[N/2 : N].  Forward output is bit-reversed-interleaved then
``bitrevorder``-ed back to natural; the inverse consumes natural order input,
bit-reverses, and emits natural order.  NOTE (``fn_radix2.m``, mirrored): the
inverse is the *unnormalized* DIT — no 1/N anywhere, matching the hardware
(the scaled mode's per-stage /2 supplies exactly 1/N).
"""

from __future__ import annotations

import numpy as np

from .twiddle import stage_twiddles_float


def bitrev_indices(n: int) -> np.ndarray:
    """Bit-reversal permutation of 0..n-1."""
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def cross_commutate(a: np.ndarray, b: np.ndarray, stg: int, n: int):
    """Inter-stage cross-commutation ``fn_rev2rdx`` (``fn_radix2.m:51-69``).

    Vectorized form of the lane exchange the ``int_delay_line`` realizes with
    delay-B / crossbar / delay-A (timing spec
    ``src/vhdl/delay/int_delay_line.vhd:60-144``).  ``stg`` is 1-based as in
    the Octave source.
    """
    cj = 1 << stg           # CNTj
    ci = (n // 2) // cj     # CNTi = block length
    # output row-block j (0-based) takes from input lane (j%2), block pair
    # base STP = 2*floor(j/2)*ci; first half of pair -> Oa, second -> Ob
    av = a.reshape(cj // 2, 2, ci)  # [pair, half, ci] view of lane A
    bv = b.reshape(cj // 2, 2, ci)
    oa = np.empty_like(av)
    ob = np.empty_like(bv)
    # j even (1-based odd): from lane A;  j odd: from lane B
    oa[:, 0], ob[:, 0] = av[:, 0], av[:, 1]
    oa[:, 1], ob[:, 1] = bv[:, 0], bv[:, 1]
    return oa.reshape(-1), ob.reshape(-1)


def cross_commutate_inv(a: np.ndarray, b: np.ndarray, stg: int, n: int):
    """``fn_rdx2rev`` (``fn_radix2.m:71-89``) — the DIT (inverse) schedule:
    identical index algebra with the stage count reversed."""
    nl = n.bit_length() - 1
    return cross_commutate(a, b, nl - stg, n)


def _twiddle_replicate(p: int, count: int) -> np.ndarray:
    """Stage twiddle vector of length ``count`` = N/2: each of the 2^p
    distinct twiddles W_{2^(p+1)}^k repeated in the lane order of
    ``fn_twiddleN_dif`` (``fn_radix2.m:109-117``): lane position
    m = n + STP*(k-1) carries W^(n-1 stride CNT)."""
    w = stage_twiddles_float(p)           # length 2^p
    rep = count // (1 << p)               # CNT segments
    # fn_twiddleN: segment k (of CNT) at stride STP holds W[(n-1)*CNT]
    # -> lane vector = tile of w's entries with stride rep? Work it out:
    # Wo(n + STP*(k-1)) = Wi((n-1)*CNT+1): STP = count/CNT entries per segment,
    # CNT = rep segments; position index i = n-1 + STP*(k-1);
    # value = w[(n-1)*CNT] -- wait CNT in fn_twiddleN is 2^(i-1) blocks and
    # stride into the *length N/2* master table. Our w is already the 2^p
    # distinct values; master index (n-1)*CNT with CNT = rep maps onto
    # distinct twiddle (n-1). So segment k holds w[0..STP-1] verbatim.
    stp = count // rep
    assert stp == 1 << p
    return np.tile(w, rep)


def fft_dif_float(x: np.ndarray) -> np.ndarray:
    """Forward DIF FFT, natural in / natural out (lane-structured,
    ``fn_fft_dif``, ``fn_radix2.m:152-190``)."""
    x = np.asarray(x, dtype=np.complex128).ravel()
    n = x.size
    nl = n.bit_length() - 1
    a, b = x[: n // 2].copy(), x[n // 2 :].copy()
    for i in range(1, nl + 1):          # 1-based stage like the Octave code
        p = nl - i                      # twiddle order of this stage
        w = _twiddle_replicate(p, n // 2)
        oa = a + b
        ob = (a - b) * w
        if i < nl:
            a, b = cross_commutate(oa, ob, i, n)
        else:
            a, b = oa, ob
    out = np.empty(n, dtype=np.complex128)
    out[0::2] = a
    out[1::2] = b
    return out[bitrev_indices(n)]


def fft_dit_float(x: np.ndarray) -> np.ndarray:
    """Inverse (DIT, conjugate twiddles) — unnormalized: returns N * ifft(x)
    (``fn_fft_dit``, ``fn_radix2.m:193-232``)."""
    x = np.asarray(x, dtype=np.complex128).ravel()
    n = x.size
    nl = n.bit_length() - 1
    xr = x[bitrev_indices(n)]
    a, b = xr[0::2].copy(), xr[1::2].copy()
    for i in range(1, nl + 1):
        p = i - 1                       # twiddle order grows in DIT
        w = np.conj(_twiddle_replicate(p, n // 2))
        bw = b * w
        oa = a + bw
        ob = a - bw
        if i < nl:
            a, b = cross_commutate_inv(oa, ob, i, n)
        else:
            a, b = oa, ob
    return np.concatenate([a, b])
