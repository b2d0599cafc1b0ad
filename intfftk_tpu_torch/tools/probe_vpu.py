"""Integer-instruction and device-memory ceilings of the card, measured: the
denominators of every kernel's roofline bound.

Counterpart of ``tools/probe_vpu.py`` (the TPU's VPU/HBM probe).  Its three
Pallas kernels are the hand-written CUDA kernels of ``csrc/probe.cu``:

* ``_chain_kernel`` (:49) -> ``probe_chain(body, x, k)``: ``k`` iterations
  of a dependent op chain ``body(c)`` on every element of an int32 tensor,
  for the ten bodies of the TPU tool (add, add16x, mul, mul16x, shift,
  bitwise, mixed7, stagemix10, select, roll);
* the int16 add chain ``mk16`` (:219-236), the TPU's "packing throughput
  probe" (the TPU keeps int16 two to a 32-bit word) ->
  ``probe_chain("add", x, k)`` on an int16 tensor (K9): two int16 values
  in one 32-bit register, sixteen chains a thread, three of four on the
  packed add ``VIADD.16x2`` (the FMA pipe), the fourth on the same exact
  add in two ALU-pipe instructions; two readings stand beside it:
  ``"add_vadd2"``, every chain ``VIADD.16x2``, and ``"add_unpacked"``, one
  int16 per register;
* ``probe_hbm`` (:135) -> ``probe_copy(x)``: ``o = x + 1``.

One int32 body is the port's own, a pipe probe: ``"pair"`` runs the packed
add on the even chains of a thread and a multiply (the FMA pipe) on the odd
ones, one instruction per element and iteration.  Where the packed add
issues on the other pipe, the pair's instructions/s read near twice the
packed chain's; where it shares the FMA pipe, near the same (as on an
H100: K9's spread over both pipes follows from it).

Beside each kernel stands its plain PyTorch version (``chain_reference``,
``copy_reference``): a CPU tensor takes it, a CUDA tensor launches the
kernel and adds one to the wrapper's ``launches``.

The measurements: ``chain_ops_per_s`` times one launch at three chain
lengths with CUDA events, the three in turn within each of several rounds,
and takes the rate from the difference of the longest and the shortest
(the median over the rounds), so load, store and launch cancel and a drift
of the clocks meets all three alike; the lengths are scaled, from a pilot
launch, until the longest takes tens of milliseconds, which is what makes
one reading steady.  Ops are counted at source level (``Body.ops`` per
element per iteration, the counts of the TPU tool).  The compiler of the
card folds what Mosaic emits verbatim, so ``check_reading`` holds each
reading to two guards, and a failed one raises ``GuardError`` (nothing is
taken again): the time is linear in the chain length (the two half-ranges
agree within 5 %), and no chain runs above ``lane_rate_peak`` (SMs x 128
lanes x the maximum SM clock) times the ops one instruction can absorb at
full fusion: a reading above that is a folded chain, not a fast card.
``sass_loop_counts`` reads what was compiled (``tools.audit_sass``).

The two ceilings of a bound (``ceilings_from``, ``same_session_ceilings``):
integer ops/s is the better of the two mixed chains, measured in the
session that uses it; device-memory bytes/s is ``memory_peak``, the card's
own memory clock x bus width, because a copy kernel's reading is a lower
rate than the card has.  The copy rate is measured beside it
(``hbm_bytes_per_s``) and held below that peak.  No number is recorded
anywhere.

Usage, on a machine with the card:

    python -m intfftk_tpu_torch.tools.probe_vpu [--quick] [--bend N]

prints one JSON dict of measured ceilings (ops/s by op class, device-memory
bytes/s) with the keys of the TPU tool (``add16_ops_per_s``: K9's packed
int16 add), and ``add16_vadd2_ops_per_s``, ``add16_unpacked_ops_per_s``,
``pair_vadd2_imad_instr_per_s`` and ``hbm_peak_bytes_per_s``;
``add_unroll16_ops_per_s`` is null (``FOLDED_KEYS``).  With ``--bend N`` it
prints instead how far N readings of each chain bent (``bend``).
"""

from __future__ import annotations

import json
import subprocess
import sys
from typing import NamedTuple

import torch

from ..device import resolve, use_kernel
from ..ops import _build
from .audit_sass import CHAINS_PER_THREAD


class Body(NamedTuple):
    """One chain body: its index in ``csrc/probe.cu``, the source-level ops
    it applies per element per iteration, the fewest instructions those ops
    compile to at full fusion (fused multiply-add, three-input logic, and
    the sixteen doublings of add16x as one shift: the counts ptxas reaches
    on an H100 or one below), and its key in the dict ``main`` prints."""
    index: int
    ops: int
    min_instr: int
    key: str


BODIES = {
    "add": Body(0, 1, 1, "add_ops_per_s"),
    "add16x": Body(1, 16, 1, "add_unroll16_ops_per_s"),
    "mul": Body(2, 1, 1, "mul_ops_per_s"),
    "mul16x": Body(3, 16, 16, "mul_unroll16_ops_per_s"),
    "shift": Body(4, 2, 1, "shift_ops_per_s"),
    "bitwise": Body(5, 2, 1, "bitwise_ops_per_s"),
    "mixed7": Body(6, 7, 4, "mixed7_ops_per_s"),
    "stagemix10": Body(7, 10, 6, "stagemix10_ops_per_s"),
    "select": Body(8, 3, 2, "select_ops_per_s"),
    "roll": Body(9, 2, 1, "roll_ops_per_s"),
    # the pipe probe: one instruction per element and iteration
    "pair": Body(11, 1, 1, "pair_vadd2_imad_instr_per_s"),
}
#: The bodies an int32 tensor takes (K7, and the pipe probe).
INT32_BODIES = tuple(BODIES)
#: The chains an int16 tensor takes: "add" (K9, the TPU tool's
#: add16_ops_per_s), two int16 values per 32-bit register, its packed adds
#: spread over both pipes; "add_vadd2", every chain the native packed add;
#: "add_unpacked", one per register, wrapped to 16 bits at every iteration.
INT16_CHAINS = {
    "add": Body(12, 1, 1, "add16_ops_per_s"),
    "add_vadd2": Body(10, 1, 1, "add16_vadd2_ops_per_s"),
    "add_unpacked": Body(0, 1, 1, "add16_unpacked_ops_per_s"),
}
#: the int16 chains by their names in ``CHAIN_ORDER``
INT16_NAMES = {"add16": "add", "add16_vadd2": "add_vadd2",
               "add16_unpacked": "add_unpacked"}
INT16_BODIES = tuple(INT16_CHAINS)
#: Threads per CTA of the chain kernel (``kThreads`` of ``csrc/probe.cu``).
CHAIN_THREADS = 256
#: The size of a timed chain's input: this many CTAs of ``chain_kernel``
#: per SM, every SM holding them all at once (the packed chains run the
#: same registers as half as many CTAs of two blocks each).
CTAS_PER_SM = 8
#: Chain lengths of a timed reading (lo, mid, hi) before they are scaled
#: to the time the longest launch shall take (ms), full and ``--quick``.
K_BASE = (4096, 10240, 16384)
TARGET_MS, TARGET_MS_QUICK = 80.0, 40.0
#: The chains in the order ``main`` measures them (the TPU tool's order of
#: keys): K7's ten, with K9 ("add16": the packed "add" on int16) and its two
#: readings before ``roll``, then the pipe probe.
CHAIN_ORDER = ("add", "add16x", "mul", "mul16x", "shift", "bitwise",
               "mixed7", "stagemix10", "select", "add16", "add16_vadd2",
               "add16_unpacked", "roll", "pair")
#: Keys published as None: ptxas compiles the sixteen doublings of add16x
#: to one shift, so its reading is no rate of adds.
FOLDED_KEYS = ("add_unroll16_ops_per_s",)
#: Guard 1: the rates of the two half-ranges agree within this share.
LINEAR_TOL = 0.05


def body_of(body: str, dtype: torch.dtype) -> Body:
    """The chain ``body`` runs on a tensor of ``dtype``: int16 takes
    ``INT16_CHAINS``, int32 ``BODIES``."""
    return (INT16_CHAINS if dtype == torch.int16 else BODIES)[body]


def per_register(body: str, dtype: torch.dtype) -> int:
    """Elements one 32-bit register of the chain holds: two for the packed
    int16 add, else one."""
    return 2 if dtype == torch.int16 and body != "add_unpacked" else 1


def chain_of(name: str) -> tuple[str, torch.dtype]:
    """(body, dtype) of a name of ``CHAIN_ORDER``."""
    if name in INT16_NAMES:
        return INT16_NAMES[name], torch.int16
    return name, torch.int32


def _check_chain(body: str, x: torch.Tensor, k: int):
    if body not in BODIES and body not in INT16_CHAINS:
        raise ValueError(f"bad body {body!r}, one of "
                         f"{INT32_BODIES + INT16_BODIES[1:]}")
    want = INT16_BODIES if x.dtype == torch.int16 else INT32_BODIES
    if x.dtype not in (torch.int32, torch.int16) or body not in want:
        raise TypeError(f"body {body!r} does not take {x.dtype}: int32 "
                        f"takes {INT32_BODIES}, int16 {INT16_BODIES}")
    if k < 0:
        raise ValueError(f"chain length {k} < 0")
    if body == "roll" and x.numel() % 32:
        raise ValueError("roll rotates runs of 32 elements: the element "
                         f"count {x.numel()} is no multiple of 32")


def chain_reference(body: str, x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of ``probe_chain`` (any device): ``body``
    applied ``k`` times to every element of an int32 (or, for the add
    chains, int16) tensor, with two's-complement wrap-around.  ``roll`` is
    the rotate by one place within each run of 32 consecutive elements,
    plus one.  ``pair``: element i belongs to chain (i // CHAIN_THREADS) %
    CHAINS_PER_THREAD of its thread; an even chain doubles the two int16
    halves of the element, each wrapping, an odd one squares it."""
    _check_chain(body, x, k)
    c = x.clone()
    if body == "pair":
        chain = torch.arange(c.numel(), device=c.device) // CHAIN_THREADS
        odd = (chain % CHAINS_PER_THREAD % 2 == 1).reshape(c.shape)
    for _ in range(k):
        if body in ("add", "add_vadd2", "add_unpacked"):
            c = c + c
        elif body == "add16x":
            for _ in range(16):
                c = c + c
        elif body == "mul":
            c = c * c
        elif body == "mul16x":
            for _ in range(16):
                c = c * c
        elif body == "shift":
            c = (c >> 1) << 1
        elif body == "bitwise":
            c = (c | 1) & -2
        elif body == "mixed7":
            d = (c >> 1) + (c << 1)
            e = c * (c | 1)
            c = d + e * c
        elif body == "stagemix10":
            d = (c >> 1) + (c << 1)
            e = (c * (c & -2)) >> 2
            f = (d - e) + c * e
            c = f + d
        elif body == "select":
            c = torch.where(c > 0, c + 1, c - 1)
        elif body == "roll":
            c = torch.roll(c.reshape(-1, 32), 1, dims=1).reshape(x.shape) + 1
        else:                                           # pair
            h = c.reshape(-1).view(torch.int16)
            c = torch.where(odd, c * c, (h + h).view(torch.int32).reshape(
                c.shape))
    return c


def probe_chain(body: str, x: torch.Tensor, k: int) -> torch.Tensor:
    """``body`` applied ``k`` times to every element of ``x`` (contiguous
    int32; int16 for "add", "add_vadd2" and "add_unpacked").  A CUDA
    tensor launches ``chain_kernel`` of ``csrc/probe.cu`` (the packed int16
    chains ``packed_chain_kernel``) on the current stream (no
    synchronisation) and adds one to ``probe_chain.launches`` (an
    int16 tensor also to ``probe_chain.launches_int16``, and the int16
    "add", K9, to ``probe_chain.launches_add16``); its element count must
    fill whole blocks of the kernel (a multiple of ``block_elems``).  A
    CPU tensor runs ``chain_reference``."""
    _check_chain(body, x, k)
    if not use_kernel(x.device):
        return chain_reference(body, x, k)
    per_cta = block_elems(body, x.dtype)
    if not x.is_contiguous() or x.numel() == 0 or x.numel() % per_cta:
        raise ValueError(f"the chain kernel takes a contiguous tensor of a "
                         f"multiple of {per_cta} elements, got "
                         f"{tuple(x.shape)}")
    y = torch.empty_like(x)
    lib = _build.library()
    err = lib.intfft_probe_chain(
        x.data_ptr(), y.data_ptr(), x.numel(), x.element_size(),
        body_of(body, x.dtype).index, k, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, f"probe_chain({body}) launch")
    probe_chain.launches += 1
    probe_chain.launches_int16 += x.dtype == torch.int16
    probe_chain.launches_add16 += x.dtype == torch.int16 and body == "add"
    return y


#: Kernel launches made by ``probe_chain`` (plain counts; reset them to 0):
#: all of them, those of the int16 chains among them, and those of the
#: int16 "add" chain (K9) among those.
probe_chain.launches = 0
probe_chain.launches_int16 = 0
probe_chain.launches_add16 = 0


def cta_elems() -> int:
    """Registers one CTA of ``chain_kernel`` holds (one element each)."""
    return _build.library().intfft_probe_cta_elems()


def block_elems(body: str, dtype: torch.dtype) -> int:
    """Elements of one block of the kernel the chain runs: a CTA of
    ``chain_kernel``, or in the packed int16 chains a block of
    ``packed_chain_kernel`` (two int16 a register)."""
    if per_register(body, dtype) == 2:
        return 2 * _build.library().intfft_probe_packed_block()
    return cta_elems()


def copy_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``probe_copy``: ``x + 1``."""
    return x + 1


def probe_copy(x: torch.Tensor, out: torch.Tensor | None = None):
    """``o = x + 1`` over a contiguous int32 tensor.  A CUDA tensor (a
    multiple of 4 elements) launches ``copy_kernel`` of ``csrc/probe.cu``
    into ``out`` (allocated when left out) and adds one to
    ``probe_copy.launches``; a CPU tensor runs ``copy_reference``."""
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise TypeError(f"probe_copy takes a contiguous int32 tensor, got "
                        f"{x.dtype}")
    if not use_kernel(x.device):
        return copy_reference(x)
    if out is None:
        out = torch.empty_like(x)
    if (x.numel() == 0 or x.numel() % 4 or out.shape != x.shape
            or out.dtype != x.dtype or out.device != x.device
            or not out.is_contiguous()):
        raise ValueError("probe_copy takes a multiple of 4 elements and an "
                         "output like its input")
    lib = _build.library()
    err = lib.intfft_probe_copy(
        x.data_ptr(), out.data_ptr(), x.numel(), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "probe_copy launch")
    probe_copy.launches += 1
    return out


#: Kernel launches made by ``probe_copy`` (a plain count).
probe_copy.launches = 0


# ------------------------------------------------------------ measurement

class GuardError(RuntimeError):
    """A reading failed one of its guards: the chain was folded or the
    timing broke.  Nothing else raises it (a failed launch is the
    RuntimeError of ``_build.check``), and nothing in the tool catches it."""


def _card(device) -> torch.device:
    device = resolve(device)
    if not use_kernel(device):
        raise RuntimeError("a ceiling is measured on the card: there is "
                           "no CPU reading")
    return device


def _event_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _event_rounds(fns, reps: int) -> list[tuple]:
    """Device times (ms) of each of ``fns``, in ``reps`` rounds: every
    round times each function once, in turn, so a drift of the card's
    clocks meets all of them alike.  One warm run of each comes first."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    return [tuple(_event_ms(fn) for fn in fns) for _ in range(reps)]


def _median(values) -> float:
    return sorted(values)[len(values) // 2]


class ChainReading(NamedTuple):
    """One timed chain: the rate over the whole range of chain lengths, the
    rates of its lower and upper half (each the median over the rounds of
    that round's own difference), the three chain lengths and the median
    launch times (ms) at them."""
    body: str
    dtype: torch.dtype
    ops_per_s: float
    ops_per_s_lo: float
    ops_per_s_hi: float
    ks: tuple
    ms: tuple


def timed_lengths(run, target_ms: float, reps: int, k_base=K_BASE):
    """The timing discipline of every marginal reading: ``run(k)`` launches
    a kernel whose time grows with k.  The three lengths are ``k_base``
    times the whole factor that brings the longest launch to ``target_ms``,
    found from one pilot launch; then ``reps`` rounds time the three in
    turn.  Returns (lengths, rounds of three times in ms)."""
    run(k_base[0])                                      # builds, warms
    pilot = _event_ms(lambda: run(k_base[2]))
    scale = max(1, round(target_ms / max(pilot, 1e-3)))
    ks = tuple(k * scale for k in k_base)
    return ks, _event_rounds([lambda k=k: run(k) for k in ks], reps)


def marginal_rates(work: float, ks, rounds) -> tuple[float, float, float]:
    """``work`` per unit of length over the marginal time, per second: over
    the whole range of lengths, its lower and its upper half, each the
    median over the rounds of that round's own difference."""
    def rate(a, b):
        return _median([work * (ks[b] - ks[a]) / max(ms[b] - ms[a], 1e-9)
                        * 1e3 for ms in rounds])

    return rate(0, 2), rate(0, 1), rate(1, 2)


def chain_input(dtype=torch.int32, device=None, seed: int = 0):
    """The tensor a timed chain runs on: ``CTAS_PER_SM`` CTAs on every SM,
    values that differ per element (made from ``seed``)."""
    device = _card(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n = sms * CTAS_PER_SM * cta_elems() * (2 if dtype == torch.int16 else 1)
    gen = torch.Generator(device=device).manual_seed(seed)
    lim = 1 << (8 * torch.empty((), dtype=dtype).element_size() - 1)
    return torch.randint(-lim, lim, (n,), dtype=dtype, device=device,
                         generator=gen)


def chain_ops_per_s(body: str, dtype=torch.int32, target_ms=TARGET_MS,
                    reps: int = 7, device=None,
                    x: torch.Tensor | None = None) -> ChainReading:
    """Time ``probe_chain(body, x, k)`` at three chain lengths and return
    the measured source-level ops/s: elements x ``Body.ops`` x (k_hi -
    k_lo) / (t_hi - t_lo).  The lengths are ``K_BASE`` times the whole
    factor that brings the longest launch to ``target_ms``, found from one
    pilot launch: a launch's time scatters by some 0.05 ms whatever its
    length, and only tens of milliseconds between two lengths make that
    small against the 5 % of guard 1 (``bend`` prints how far readings
    bent: on an H100 at most 0.96 % of 96 readings at 80 ms and 1.24 % at
    40 ms, where launches of 1 to 10 ms bent past 5 %)."""
    if x is None:
        x = chain_input(dtype, device)
    ks, rounds = timed_lengths(lambda k: probe_chain(body, x, k), target_ms,
                               reps)
    work = x.numel() * body_of(body, x.dtype).ops
    return ChainReading(body, x.dtype, *marginal_rates(work, ks, rounds), ks,
                        tuple(_median(col) for col in zip(*rounds)))


def lane_rate_peak(device=None) -> float:
    """SMs x 128 lanes x the maximum SM clock (Hz): more lane-instructions
    per second than the card can start of any kind."""
    device = _card(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits", "-i", str(device.index)],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return sms * 128 * float(mhz.strip().splitlines()[0]) * 1e6


def memory_peak(device=None) -> float:
    """The card's device-memory peak (bytes/s) from its attributes: memory
    clock x 2 transfers x bus width (3.35e12 on an H100 SXM, the data
    sheet's rate).  The bytes of every bound are held against it: a copy
    kernel's own reading is a lower rate than the card has and would
    flatter every bytes-bound row."""
    device = _card(device)
    peak = _build.library().intfft_probe_mem_peak(device.index)
    if peak <= 0:
        _build.check(_build.library(), -peak, "memory_peak attributes")
        raise RuntimeError("the card reports no memory clock or bus width")
    return float(peak)


def check_reading(r: ChainReading, peak: float):
    """The two guards of a chain reading; raises GuardError when one
    fails.  ``peak``: ``lane_rate_peak``."""
    b = body_of(r.body, r.dtype)
    if abs(r.ops_per_s_lo - r.ops_per_s_hi) > LINEAR_TOL * r.ops_per_s:
        raise GuardError(
            f"chain {r.body}: time is not linear in the chain length (ms "
            f"{r.ms} at {r.ks}; {r.ops_per_s_lo:.4g} and "
            f"{r.ops_per_s_hi:.4g} ops/s over the two half-ranges)")
    limit = peak * b.ops / b.min_instr * per_register(r.body, r.dtype)
    if not 0 < r.ops_per_s <= limit:
        raise GuardError(
            f"chain {r.body}: {r.ops_per_s:.4g} ops/s is above "
            f"{limit:.4g} (lanes x clock x {b.ops}/{b.min_instr} ops per "
            f"instruction): a folded chain, not a fast card")


def probe_hbm(nbytes: int = 1 << 28, device=None, reps: int = 5) -> float:
    """Streaming copy rate (bytes/s) through ``probe_copy``: ``nbytes``
    read and ``nbytes`` written per launch, timed over the difference of 8
    and 2 chained launches.  A reading above ``memory_peak`` was mistimed
    and raises GuardError."""
    device = _card(device)
    x = torch.ones(nbytes // 4, dtype=torch.int32, device=device)
    o = torch.empty_like(x)

    def run(k):
        a, b = x, o
        for _ in range(k):
            probe_copy(a, out=b)
            a, b = b, a

    k_lo, k_hi = 2, 8
    rounds = _event_rounds([lambda: run(k_lo), lambda: run(k_hi)], reps)
    dt = _median([hi - lo for lo, hi in rounds]) / (k_hi - k_lo) * 1e-3
    rate = 2 * nbytes / max(dt, 1e-12)
    if not 0 < rate <= memory_peak(device):
        raise GuardError(f"copy: {rate:.4g} bytes/s is above the card's "
                         f"memory peak {memory_peak(device):.4g}")
    return rate


def measure_all(quick: bool = False, device=None, emit=None,
                bodies=None) -> dict:
    """Every ceiling of ``main``, as {key: value}: the chains of ``bodies``
    (names of ``CHAIN_ORDER``, all of them when left out), each held to
    ``check_reading``, then the copy rate ``hbm_bytes_per_s`` and the
    card's ``hbm_peak_bytes_per_s``
    (``memory_peak``).  A key of ``FOLDED_KEYS`` is timed and guarded like
    the others and published as None.  ``emit(key, value)`` is called as
    each arrives."""
    device = _card(device)
    peak = lane_rate_peak(device)
    target = TARGET_MS_QUICK if quick else TARGET_MS
    out = {}

    def put(key, value):
        out[key] = None if key in FOLDED_KEYS else value
        if emit is not None:
            emit(key, out[key])

    xs = {t: chain_input(t, device) for t in (torch.int32, torch.int16)}
    for name in CHAIN_ORDER if bodies is None else bodies:
        body, dtype = chain_of(name)
        r = chain_ops_per_s(body, target_ms=target, x=xs[dtype])
        check_reading(r, peak)
        put(body_of(body, dtype).key, r.ops_per_s)
    put("hbm_bytes_per_s", probe_hbm(1 << 26 if quick else 1 << 28, device))
    put("hbm_peak_bytes_per_s", memory_peak(device))
    return out


def ceilings_from(measured: dict) -> tuple[float, float]:
    """The roofline denominators (int ops/s, device-memory bytes/s) of a
    dict of ``measure_all``: the better of the two mixed chains (the
    speed-of-light convention) and the card's memory peak.  The copy
    kernel's own rate is information, not a ceiling."""
    return (max(measured["mixed7_ops_per_s"],
                measured["stagemix10_ops_per_s"]),
            measured["hbm_peak_bytes_per_s"])


def same_session_ceilings(quick: bool = False, device=None):
    """(int ops/s, device-memory bytes/s) of the card, the ops measured in
    this process: ``ceilings_from`` a ``measure_all`` of the two mixed
    chains alone."""
    return ceilings_from(measure_all(quick, device,
                                     bodies=("mixed7", "stagemix10")))


def sass_loop_counts(so_path) -> dict:
    """SASS instructions in the chain loop of each compiled chain kernel,
    {(body index, storage letter): instructions per iteration}: the loop's
    whole span (the work of the kernel's 8 independent chains plus the
    loop's own counter, compare and branch), read by
    ``tools.audit_sass``, which also counts it by class."""
    from . import audit_sass

    return audit_sass.chain_loop_sizes(audit_sass.read_sass(so_path))


def bend(readings: int, quick: bool = False, device=None) -> int:
    """How steady one reading is: ``readings`` readings of every chain, and
    for each chain the worst share by which the rates of the two
    half-ranges differed (guard 1 allows ``LINEAR_TOL``) and the spread of
    the rate itself.  Prints one line per chain; no guard is applied."""
    device = _card(device)
    target = TARGET_MS_QUICK if quick else TARGET_MS
    xs = {t: chain_input(t, device) for t in (torch.int32, torch.int16)}
    for name in CHAIN_ORDER:
        body, dtype = chain_of(name)
        rs = [chain_ops_per_s(body, target_ms=target, x=xs[dtype])
              for _ in range(readings)]
        worst = max(abs(r.ops_per_s_lo - r.ops_per_s_hi) / r.ops_per_s
                    for r in rs)
        rates = sorted(r.ops_per_s for r in rs)
        print(f"{name:12s} longest launch {rs[-1].ms[2]:7.2f} ms, worst "
              f"bend {worst:.2%} of {readings} readings, rate "
              f"{rates[0] / 1e12:.3f}-{rates[-1] / 1e12:.3f} T ops/s",
              flush=True)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv

    def emit(key, value):
        unit = "TB/s" if "bytes" in key else "Top/s"
        print(f"{key:26s} " + ("  folded" if value is None else
                               f"{value / 1e12:8.3f} {unit}"),
              file=sys.stderr, flush=True)

    if "--bend" in argv:
        return bend(int(argv[argv.index("--bend") + 1]), "--quick" in argv)
    out = measure_all(quick="--quick" in argv, emit=emit)
    print(json.dumps({k: v if v is None else round(v, 1)
                      for k, v in out.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
