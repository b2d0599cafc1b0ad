"""Compiled-code audit: counts the instructions the card runs, by class,
from the SASS of the built kernel library.

Counterpart of ``tools/audit_mosaic.py``.  There the probe chain
(``audit_probe_chain``, its ``pallas_call`` at :247) and the headline
kernel are lowered and the Mosaic module is counted op by op, so that the
ceiling's denominator and the kernel's numerator come from one counter.
On the card the chain kernel exists already (``chain_kernel`` of
``csrc/probe.cu``), the compiled artifact is SASS, and what is ported is
the counter:

* ``read_sass(so)``: ``cuobjdump -sass`` of the library, parsed into
  ``{function: [Instr]}``; the tool raises where the toolkit has no
  ``cuobjdump``;
* ``classify`` / ``count_loop``: instructions of a loop (the span from the
  target of a backward branch to that branch) by class: ``alu`` (IADD3,
  IMAD, LOP3, SHF, ISETP, SEL, LEA, ...), ``move`` (MOV, PRMT, SHFL, S2R),
  ``memory`` (LDS, STS, LDG, STG, LDC, ...), ``barrier`` (BAR), ``control``
  (branches and convergence points inside the body), ``uniform`` (the
  uniform datapath's U* instructions), ``loop`` (the loop's own closing
  branch and, where they can be told, its compare and counter); an opcode
  in no class counts as ``unknown``, so the classifier cannot under-count
  silently.  Shared-memory loads, stores and barriers are counted like
  everything else: an instruction that moves data takes an issue slot as
  one that adds.  ``issued`` is every class but ``loop``.  Beside the
  classes stand the two integer pipes of an SM, each half as wide as the
  SM's issue: ``fma_pipe`` (every IMAD form, the copies and adds the
  compiler writes as IMAD among them) and ``alu_pipe`` (the other ``alu``
  and ``move`` instructions: adds, logic, shifts, compares, selects);
* ``audit_probe_chain(body, int16=)``: instructions per iteration and
  chain of ``chain_kernel<body>``: the ceiling's denominator, and the issue
  limit of the int16 chains (K9); ``loop_opcodes``: a loop's opcodes with
  their modifiers (the packed add's ``VIADD.16x2``);
* ``audit_stage(step)``: instructions per butterfly of
  ``stage_loop_kernel<step>`` (``csrc/probe_stages.cu``): the numerator by
  step.  A round-trip step (``prod_p*``) stores four words per butterfly; a
  group step (``group{R}_p*``, the function the factor pass runs) stores
  2 x 2^R words per task of R x 2^(R-1) butterflies.  The count is clean
  there, because the group's orders are template parameters:
  ``fused_pass_kernel``'s own group loops hold both operand sources, both
  destinations and both epilogue forms behind run-time branches, so their
  static span over-counts every group;
* ``group_split(log_rows)``: the groups the pass runs a factor in, the same
  split the launch uses (``group_of`` of ``csrc/stage_body.cuh``; the
  library reports its own through ``intfft_group_split`` and the card's
  tests hold the two equal);
* ``audit_transform(n1, n2)``: instructions per sample of a transform
  through the pass: for each factor the sum over its groups of the group
  step that stands for it (same stages, same tile, same twiddle forms), and
  the inter-factor product;
* ``audit_headline()``: both, for the 64k headline (256 x 256): the static
  span of the largest group loop of ``fused_pass_kernel<int16, int16,
  int32, false, false>`` in the form the headline takes (products modulo
  2^32), and ``audit_transform(256, 256)`` per sample; the same for the
  int64 instantiation; ``audit_pass_static`` counts either product form
  of either tile;
* ``summarize(counts, samples)``: per-sample numbers by class.

Usage, on a machine with the card's toolkit (builds the library first):

    python -m intfftk_tpu_torch.tools.audit_sass [--probes] [--dump DIR]

prints one JSON dict; ``--probes`` adds the chain bodies, ``--dump`` writes
the SASS text of the functions the audit reads (the test fixtures).
"""

from __future__ import annotations

import functools
import json
import re
import sys
from pathlib import Path
from typing import NamedTuple


class Instr(NamedTuple):
    """One SASS instruction: its address, its predicate ("" or e.g.
    "@!P0"), its opcode with modifiers (e.g. "IMAD.WIDE") and its operand
    text."""
    addr: int
    pred: str
    opcode: str
    operands: str


CLASSES = ("alu", "move", "memory", "barrier", "control", "uniform",
           "unknown", "loop")

_ALU = frozenset("""
    IADD3 IADD IMAD LOP3 LOP SHF SHL SHR ISETP ICMP SEL VIADD VABSDIFF
    VABSDIFF4 VIMNMX VIADDMNMX IMNMX LEA IABS FLO POPC BREV BMSK SGXT PLOP3
    PSETP P2R
    R2P I2I I2IP IDP IDP4A F2I I2F I2FP F2F F2FP FADD FMUL FFMA FSETP FSEL
    FMNMX MUFU HADD2 HMUL2 HFMA2 HSETP2 HMNMX2 DADD DMUL DFMA DSETP FCHK
    FRND""".split())
_MOVE = frozenset("""
    MOV PRMT SHFL S2R CS2R R2UR S2UR MOVM VOTE VOTEU MATCH REDUX
    """.split())
_MEMORY = frozenset("""
    LD ST LDG STG LDS STS LDL STL LDC LDSM STSM ATOM ATOMS ATOMG RED CCTL
    CCTLL MEMBAR LDGSTS UBLKCP UTMALDG UTMASTG""".split())
#: UCGABAR_*: the cluster barrier (barrier.cluster.arrive / wait) of the
#: whole four-step's cluster kernel.
_BARRIER = frozenset(["BAR", "SYNCS", "ARRIVES", "UCGABAR_ARV",
                      "UCGABAR_WAIT"])
_CONTROL = frozenset("""
    BRA BRX JMP JMX CALL RET EXIT BSSY BSYNC BREAK BMOV WARPSYNC NOP YIELD
    NANOSLEEP DEPBAR LDGDEPBAR ERRBAR CGAERRBAR KILL BPT RPCMOV ACQBULK
    ENDCOLLECTIVE
    """.split())
#: Opcode bases that run on the FMA pipe; the other register arithmetic and
#: moves run on the ALU pipe.
_FMA_PIPE = frozenset(
    "IMAD IDP IDP4A FFMA FMUL FADD HFMA2 HADD2 HMUL2".split())
PIPES = ("fma_pipe", "alu_pipe")
#: Opcodes that increment a loop's counter.
_COUNTER_OPS = frozenset(["IADD3", "VIADD", "IADD", "IMAD", "UIADD3", "LEA"])


def classify(opcode: str) -> str:
    """The class of an opcode (with or without modifiers)."""
    parts = opcode.split(".")
    base = parts[0]
    if base == "IMAD" and "MOV" in parts[1:]:
        return "move"                       # IMAD.MOV.U32: a register copy
    if base in _ALU:
        return "alu"
    if base in _MOVE:
        return "move"
    if base in _MEMORY:
        return "memory"
    if base in _BARRIER:
        return "barrier"
    if base in _CONTROL:
        return "control"
    if base.startswith("U") and (base[1:] in _ALU or base[1:] in _MOVE
                                 or base[1:] == "LDC"):
        return "uniform"
    return "unknown"


class Counts(dict):
    """{class: {opcode base: instructions}}."""

    def add(self, cls: str, name: str, n: int = 1):
        by = self.setdefault(cls, {})
        by[name] = by.get(name, 0) + n

    def total(self, *classes: str) -> int:
        """Instructions of ``classes``; of every class when none is named."""
        return sum(sum(v.values()) for k, v in self.items()
                   if not classes or k in classes)

    def pipe(self, fma: bool) -> int:
        """The ``alu`` and ``move`` instructions on the FMA pipe, or the
        others (the ALU pipe)."""
        return sum(n for c in ("alu", "move") for op, n in self.get(
            c, {}).items() if (op in _FMA_PIPE) == fma)

    def scaled(self, by: float) -> dict:
        """Per-class totals, and the two pipes', divided by ``by``."""
        out = {c: self.total(c) / by for c in CLASSES if c in self}
        out.update(fma_pipe=self.pipe(True) / by,
                   alu_pipe=self.pipe(False) / by)
        return out


def find_cuobjdump() -> str:
    """The toolkit's ``cuobjdump``: on the path, or beside ``nvcc``.  Raises
    RuntimeError where there is none: the audit has no other reader."""
    import shutil

    found = shutil.which("cuobjdump")
    if found:
        return found
    from ..ops import _build

    beside = Path(_build.find_nvcc()).with_name("cuobjdump")
    if beside.exists():
        return str(beside)
    raise RuntimeError("cuobjdump not found: the compiled-code audit reads "
                       "the library's SASS with it")


def dump_sass(so_path) -> str:
    """The text ``cuobjdump -sass`` prints for a library."""
    import subprocess

    return subprocess.run([find_cuobjdump(), "-sass", str(so_path)],
                          capture_output=True, text=True, timeout=600,
                          check=True).stdout


_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]+?)\s*;")
_TARGET = re.compile(r"`?\(?0x([0-9a-f]+)\)?\s*$")


def split_functions(text: str) -> dict[str, str]:
    """{mangled function name: its part of a ``cuobjdump -sass`` text}."""
    out = {}
    for part in text.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        out[name.strip()] = body
    return out


def parse_function(body: str) -> list[Instr]:
    """The instructions of one function's SASS text, in address order."""
    ins = []
    for addr, text in _INSTR.findall(body):
        pred = ""
        if text.startswith("@"):
            pred, _, text = text.partition(" ")
        opcode, _, operands = text.strip().partition(" ")
        ins.append(Instr(int(addr, 16), pred, opcode, operands.strip()))
    return ins


def parse_sass(text: str) -> dict[str, list[Instr]]:
    """{function: [Instr]} of a ``cuobjdump -sass`` text."""
    return {name: parse_function(body)
            for name, body in split_functions(text).items()}


def read_sass(so_path) -> dict[str, list[Instr]]:
    """{function: [Instr]} of a built library (``cuobjdump -sass``)."""
    return parse_sass(dump_sass(so_path))


def loops(instrs: list[Instr]) -> list[tuple[int, int]]:
    """The loops of a function as (first address, address of the backward
    branch), in the order of their branches.  A backward branch whose span
    holds an EXIT closes no loop: it is the way back from a block the
    compiler laid after the function's body (the divergent path of a warp
    shuffle)."""
    out = []
    exits = [i.addr for i in instrs if i.opcode.split(".")[0] == "EXIT"]
    for i in instrs:
        if i.opcode.split(".")[0] in ("BRA", "JMP"):
            m = _TARGET.search(i.operands)
            if m and int(m.group(1), 16) < i.addr and not any(
                    int(m.group(1), 16) <= e <= i.addr for e in exits):
                out.append((int(m.group(1), 16), i.addr))
    return out


def _span(instrs, span):
    return [i for i in instrs if span[0] <= i.addr <= span[1]]


def _dest(i: Instr) -> str:
    return i.operands.split(",")[0].strip()


def _loop_own(body: list[Instr]) -> set[int]:
    """Addresses of a loop's own compare and counter increment, where they
    can be told: the ISETP that writes the backward branch's predicate, and
    the add that steps the register it compares."""
    own = set()
    pred = body[-1].pred.lstrip("@!")
    if not pred:
        return own
    cmp_ = next((i for i in reversed(body[:-1])
                 if i.opcode.split(".")[0] in ("ISETP", "UISETP")
                 and _dest(i) == pred), None)
    if cmp_ is None:
        return own
    own.add(cmp_.addr)
    regs = set(re.findall(r"\bU?R\d+\b", cmp_.operands))
    for i in reversed(body[:-1]):
        if (i.opcode.split(".")[0] in _COUNTER_OPS and _dest(i) in regs
                and re.search(rf"\b{_dest(i)}\b",
                              i.operands.partition(",")[2])):
            own.add(i.addr)
            break
    return own


def count_loop(instrs: list[Instr], span: tuple[int, int] | None = None
               ) -> Counts:
    """Instructions by class over a loop: ``span`` (one of ``loops``), by
    default the span from the target of the last backward branch to that
    branch.  The branch, and the loop's own compare and counter where they
    can be told, count as ``loop``."""
    if span is None:
        found = loops(instrs)
        if not found:
            raise ValueError("no backward branch: the function has no loop")
        span = found[-1]
    body = _span(instrs, span)
    own = _loop_own(body) | {span[1]}
    counts = Counts()
    for i in body:
        cls = "loop" if i.addr in own else classify(i.opcode)
        counts.add(cls, i.opcode.split(".")[0])
    return counts


def _stores(body: list[Instr]) -> int:
    return sum(i.opcode.split(".")[0] == "STS" for i in body)


def inner_loops(instrs: list[Instr]) -> list[tuple[int, int]]:
    """The loops nested in another loop that hold no loop themselves."""
    found = loops(instrs)
    return [s for s in found
            if any(o != s and o[0] <= s[0] and s[1] <= o[1] for o in found)
            and not any(o != s and s[0] <= o[0] and o[1] <= s[1]
                        for o in found)]


def butterfly_loop(instrs: list[Instr], words: int = 4
                   ) -> tuple[tuple[int, int], int]:
    """The loop of a stage kernel or of the factor pass that does the
    butterflies, and the units of work one trip of it runs: of
    ``inner_loops`` the one with the most shared-memory stores (the longest
    of those), which stores ``words`` words per unit: four per butterfly of
    a round-trip stage, 2 x 2^R per task of a stage group (where the
    compiler unrolled the loop, its remainder loops store fewer)."""
    inner = inner_loops(instrs)
    if not inner:
        raise ValueError("no nested loop: not a stage kernel")
    best = max(inner, key=lambda s: (_stores(_span(instrs, s)),
                                    len(_span(instrs, s))))
    stores = _stores(_span(instrs, best))
    if stores == 0 or stores % words:
        raise ValueError(f"the nested loop stores {stores} words to shared "
                         f"memory: not a whole number of units of {words}")
    return best, stores // words


def register_loop(instrs: list[Instr]) -> tuple[int, int]:
    """The k loop of a register step: of ``inner_loops`` the longest."""
    inner = inner_loops(instrs)
    if not inner:
        raise ValueError("no nested loop: not a stage kernel")
    return max(inner, key=lambda s: len(_span(instrs, s)))


# ------------------------------------------------------- the kernels' names

def find_function(sass: dict, pattern: str) -> str:
    """The one function whose mangled name matches ``pattern``."""
    names = [n for n in sass if re.search(pattern, n)]
    if len(names) != 1:
        raise KeyError(f"{len(names)} functions match {pattern!r}")
    return names[0]


def chain_pattern(index: int, letter: str = "j") -> str:
    """``chain_kernel<index, T>``: T = "j" (uint32_t) or "t" (uint16_t);
    "p": ``packed_chain_kernel<index>``."""
    if letter == "p":
        return rf"packed_chain_kernelILi{index}EE"
    return rf"chain_kernelILi{index}E{letter}E"


def stage_pattern(index: int, order: int, wide: bool = False,
                  threads: int | None = None, layout: int = 0) -> str:
    """``stage_loop_kernel<index, order, V, threads, layout>``: V int32_t,
    or int64_t; by default at the threads per CTA the pass takes at m = 256
    on the H100's tuning row (128 on the int32 tile, 256 on the int64
    tile), on the pass's layout of the tile (0; 1 the swizzled one)."""
    if threads is None:
        from ..ops.tuning import TUNINGS, pass_geometry

        threads = pass_geometry(TUNINGS["sm_90"], 256, None, wide)["threads"]
    return (rf"stage_loop_kernelILi{index}ELi{order}E{'l' if wide else 'i'}"
            rf"Li{threads}ELi{layout}EE")


def pass_pattern(wide: bool = False, threads: int | None = None,
                 inverse: bool = False, mod: bool = False,
                 skew: bool = False) -> str:
    """The 1-D-table instantiation of ``fused_pass_kernel``, forward unless
    ``inverse``: int16 blocks on the int32 tile (the 64k headline), or
    int64 on int64, at ``threads`` threads per CTA: by default the count
    the headline's passes (m = 256), or on the int64 tile the config-2
    chain's, take from the card's tuning row; with ``mod`` the kernel
    whose products are formed modulo the tile's word (2^32 on the int32
    tile: the form the headline takes; 2^64 on the int64 tile); with
    ``skew`` the forward's kernel on the skewed tile (the headline's first
    pass, whose store is turned and in natural order), else the padded
    one (its second); never an instance with the convolution's edge.  A
    library whose kernel has no thread count, no product form, no skew or
    no edge among its template parameters (before the tuning layer, the
    modular form, the skewed tile, the edges) matches the exact form, the
    padded tile and no edge too."""
    if threads is None:
        from ..ops.tuning import TUNINGS, pass_geometry

        threads = pass_geometry(TUNINGS["sm_90"], 256, 256, wide)["threads"]
    form = "Lb1E" if mod else "Lb0E" if skew else "(?:Lb0E)?"
    tile = "Lb1E" if skew else "(?:Lb0E)?"
    return (r"fused_pass_kernelI" + ("lll" if wide else "ssi")
            + rf"Lb{int(inverse)}ELb0E(?:Li{threads}E)?{form}{tile}"
            + r"(?:Li0E)?E")


def chain_loop_sizes(sass: dict) -> dict:
    """{(body index, storage letter): instructions in the chain loop} of
    every compiled chain kernel (``chain_pattern``'s letters): the whole
    span, the loop's own included."""
    out = {}
    for name, ins in sass.items():
        m = re.search(r"(packed_)?chain_kernelILi(\d+)E(\w)E", name)
        if m and loops(ins):
            key = int(m.group(2)), "p" if m.group(1) else m.group(3)
            out[key] = count_loop(ins, chain_loop(ins)).total()
    return out


# ---------------------------------------------------------------- the audits

#: Stages of a full group of the factor pass, by tile: [int32, int64]
#: (``GroupSize`` of ``csrc/stage_body.cuh``).
GROUP_SIZE = (3, 3)


def group_split(log_rows: int, wide: bool = False) -> list[tuple[int, int]]:
    """The groups the factor pass runs a factor of ``2**log_rows`` rows in,
    as (top order, stages) from the top order down: ``GROUP_SIZE`` orders
    each, the remainder at the bottom (``group_of`` of
    ``csrc/stage_body.cuh``, which the library reports through
    ``intfft_group_split``).  The forward runs them in this order, the
    inverse the other way."""
    r = GROUP_SIZE[bool(wide)]
    out = [(q, r) for q in range(log_rows - 1, log_rows % r - 1, -r)]
    if log_rows % r:
        out.append((log_rows % r - 1, log_rows % r))
    return out


#: Independent chains per thread of ``chain_kernel`` (``csrc/probe.cu``),
#: and of ``packed_chain_kernel`` (``kIlpPacked``).
CHAINS_PER_THREAD = 8
PACKED_CHAINS_PER_THREAD = 16
#: Samples per thread and trip of a register step (``csrc/probe_stages.cu``).
SAMPLES_PER_TRIP = 8


def audit_probe_chain(body: str, sass: dict | None = None,
                      int16: bool = False) -> Counts:
    """Instructions of one trip of ``chain_kernel<body>``'s loop by class:
    ``chains_per_thread`` chains' worth (divide by it for instructions per
    iteration and chain, that is per register).  ``int16``: the chain an
    int16 tensor takes (``probe_vpu.INT16_CHAINS``)."""
    ins = chain_function(body, sass, int16)
    return count_loop(ins, chain_loop(ins))


def chains_per_thread(body: str, int16: bool = False) -> int:
    """Independent chains a thread of the chain's kernel runs."""
    return (PACKED_CHAINS_PER_THREAD if int16 and body != "add_unpacked"
            else CHAINS_PER_THREAD)


def chain_loop(instrs: list[Instr]) -> tuple[int, int]:
    """The K loop of a chain kernel: the last loop that holds no other
    (``packed_chain_kernel`` runs it inside its loop over blocks)."""
    found = loops(instrs)
    return [s for s in found if not any(
        o != s and s[0] <= o[0] and o[1] <= s[1] for o in found)][-1]


def chain_function(body: str, sass: dict | None = None,
                   int16: bool = False) -> list[Instr]:
    """The SASS of the chain kernel ``probe_chain(body, x)`` launches on an
    int32 tensor, or on an int16 one: the packed chains are
    ``packed_chain_kernel``, "add_unpacked" holds one int16 in a
    uint16_t."""
    import torch

    from . import probe_vpu

    sass = library_sass() if sass is None else sass
    dtype = torch.int16 if int16 else torch.int32
    if probe_vpu.per_register(body, dtype) == 2:
        letter = "p"
    else:
        letter = "t" if int16 else "j"
    index = probe_vpu.body_of(body, dtype).index
    return sass[find_function(sass, chain_pattern(index, letter))]


def loop_opcodes(instrs: list[Instr]) -> dict[str, int]:
    """{opcode with its modifiers: count} over a chain kernel's K loop
    (``chain_loop``), the loop's own branch, compare and counter
    included."""
    span = chain_loop(instrs)
    out = {}
    for i in _span(instrs, span):
        out[i.opcode] = out.get(i.opcode, 0) + 1
    return out


def audit_stage(step: str, sass: dict | None = None,
                threads: int | None = None, layout: int = 0) -> dict:
    """Instructions per butterfly (two samples) of
    ``stage_loop_kernel<step>`` by class, as {class: count}, from its
    butterfly loop; a register step's loop is its k loop; a group step's
    loop runs tasks of R x 2^(R-1) butterflies.  ``threads`` and
    ``layout``: the instantiation (``stage_pattern``'s defaults: the
    pass's geometry and layout at m = 256)."""
    from . import probe_stages

    sass = library_sass() if sass is None else sass
    s = probe_stages.STEPS[step]
    index = probe_stages.kernel_index(step, probe_stages.probe_config())
    ins = sass[find_function(sass, stage_pattern(
        index, s.order, s.wide, threads, 0 if s.in_registers else layout))]
    if s.in_registers:
        return count_loop(ins, register_loop(ins)).scaled(
            SAMPLES_PER_TRIP / 2)
    if s.index in probe_stages.GROUPS:
        span, tasks = butterfly_loop(ins, 2 << s.stages)
        return count_loop(ins, span).scaled(
            tasks * s.stages * (1 << s.stages) / 2)
    span, butterflies = butterfly_loop(ins)
    return count_loop(ins, span).scaled(butterflies)


def audit_pass_static(wide: bool = False, sass: dict | None = None,
                      inverse: bool = False, mod: bool = False,
                      skew: bool = False) -> dict:
    """Instructions per butterfly of ``fused_pass_kernel``'s largest group
    loop by class (``pass_pattern``'s instantiation; ``mod``: the modular
    product form; ``skew``: on the skewed tile): a static count, which
    holds both operand sources, both destinations and both forms of the
    inter-factor product."""
    sass = library_sass() if sass is None else sass
    ins = sass[find_function(sass, pass_pattern(wide, None, inverse, mod,
                                                skew))]
    r = GROUP_SIZE[bool(wide)]
    span, tasks = butterfly_loop(ins, 2 << r)
    return count_loop(ins, span).scaled(tasks * r * (1 << r) / 2)


def group_step_for(top: int, stages: int, wide: bool, sass: dict,
                   two_d: bool = False) -> str:
    """The group step of ``sass`` that stands for the group of ``stages``
    stages from the order ``top`` down: same stages, same tile, and the
    same twiddle forms: its lowest order 0, 1, or at least 2 (every stage
    multiplies, as every stage of a group with 2-D tables does: ``two_d``).
    Groups that differ only in how far above 2 their orders lie run the
    same code; where no step of the very form was compiled, the nearest
    form with more products stands for it (an over-count), and failing
    that the nearest with fewer (an under-count: the one-stage tail of a
    factor with 2-D tables, counted as the order-0 stage)."""
    from . import probe_stages

    form = 2 if two_d else min(top - stages + 1, 2)
    have = {}
    for name, s in probe_stages.STEPS.items():
        if (s.index in probe_stages.GROUPS and not s.variant_of
                and s.stages == stages and s.wide == bool(wide) and any(
                    re.search(stage_pattern(s.index, s.order, s.wide), f)
                    for f in sass)):
            have.setdefault(min(s.order - s.stages + 1, 2), []).append(
                (abs(s.order - top), name))
    for f in (*range(form, 3), *range(form - 1, -1, -1)):
        if f in have:
            return min(have[f])[1]
    raise KeyError(f"no compiled group step of {stages} stages on the "
                   f"{'int64' if wide else 'int32'} tile")


def _add(a: dict, b: dict, times: float = 1.0) -> dict:
    return {c: a.get(c, 0.0) + times * b.get(c, 0.0)
            for c in set(a) | set(b)}


def audit_factor(log_rows: int, wide: bool = False,
                 sass: dict | None = None, two_d: bool = False) -> dict:
    """Instructions per sample by class of the forward stages of one factor
    of ``2**log_rows`` rows: for each group of ``group_split`` its stages
    times half a butterfly of the group step that stands for it
    (``group_step_for``).  A pass's load, store and reorder are not in
    it."""
    sass = library_sass() if sass is None else sass
    total: dict = {}
    for top, stages in group_split(log_rows, wide):
        step = group_step_for(top, stages, wide, sass, two_d)
        total = _add(total, audit_stage(step, sass), 0.5 * stages)
    return total


def audit_transform(n1: int, n2: int = 1, wide: bool = False,
                    sass: dict | None = None, two_d: bool = False,
                    product: bool | None = None) -> dict:
    """Instructions per sample by class of a forward transform of n1 x n2
    points through the factor pass: the groups of both factors
    (``audit_factor``; ``two_d``: the first factor's stages read the 2-D
    tables) and, with a second factor unless ``product`` says otherwise,
    the inter-factor product.  The product is counted with the round trip
    of the ``epilogue_cmult`` step, which the pass, multiplying the last
    group's registers, no longer makes: two loads and two stores per sample
    too many."""
    sass = library_sass() if sass is None else sass
    total = audit_factor(n1.bit_length() - 1, wide, sass, two_d)
    if n2 > 1:
        total = _add(total, audit_factor(n2.bit_length() - 1, wide, sass))
    if (n2 > 1) if product is None else product:
        epi = "epilogue64_cmult" if wide else "epilogue_cmult"
        total = _add(total, audit_stage(epi, sass), 0.5)
    return total


def audit_headline(sass: dict | None = None) -> dict:
    """The 64k headline (256 x 256) and its int64 twin: per butterfly the
    static span of the pass's largest group loop, in the product form each
    takes (the headline modulo 2^32, the twin exact), per sample the sum
    over its groups (the group steps of the stage probe, whose products
    are exact)."""
    sass = library_sass() if sass is None else sass
    out = {}
    for name, wide in (("narrow", False), ("int64", True)):
        out[name] = {
            "static_per_butterfly": audit_pass_static(wide, sass,
                                                      mod=not wide),
            "per_sample": audit_transform(256, 256, wide, sass)}
    return out


def issued(per: dict) -> float:
    """Of a {class: count} dict, what the stage itself issues: every class
    but the loop's own branch, compare and counter."""
    return sum(per.get(c, 0.0) for c in CLASSES if c != "loop")


def summarize(per: dict, samples: float = 1.0) -> dict:
    """Per-sample numbers of a {class: count} dict over ``samples``:
    ``alu``, ``move`` (moves, shuffles), ``mem`` (with barriers), under the
    TPU tool's class names where they mean the same, and ``issued``."""
    g = lambda *cs: round(sum(per.get(c, 0.0) for c in cs) / samples, 3)
    return {"alu": g("alu"), "move": g("move"), "mem": g("memory", "barrier"),
            "other": g("unknown"), "control": g("control"),
            "uniform": g("uniform"), "loop": g("loop"),
            "issued": round(issued(per) / samples, 3),
            "fma_pipe": g("fma_pipe"), "alu_pipe": g("alu_pipe")}


@functools.cache
def library_text() -> str:
    """``cuobjdump -sass`` of the kernel library, built first if needed;
    read once per process."""
    from ..ops import _build

    return dump_sass(_build.build()[0])


@functools.cache
def library_sass() -> dict:
    """The parsed SASS of the kernel library."""
    return parse_sass(library_text())


def fixture_text(text: str, patterns) -> str:
    """What a test fixture keeps of a ``cuobjdump -sass`` text: the
    functions matching ``patterns``, each under its ``Function :`` line,
    one instruction per line as ``/*address*/ text ;`` (the encoding
    columns and the padding are cut: they are nine tenths of the dump)."""
    parts = split_functions(text)
    keep = [n for n in parts if any(re.search(p, n) for p in patterns)]
    return "".join(
        f"\t\tFunction : {n}\n" + "".join(
            f"/*{addr}*/ {' '.join(ins.split())} ;\n"
            for addr, ins in _INSTR.findall(parts[n])) for n in keep)


#: The functions of the test fixture: the chain that sets the ceiling, the
#: exact form of the headline's pass, and the stage kernels the sum over
#: groups and the loop finders are tested on.  The headline's passes in the
#: form they take, modulo 2^32, on the padded tile (the second pass) and
#: the skewed one (the first), are a second fixture (``MOD32_FIXTURE``).
FIXTURE_STEPS = ("prod_p0", "prod_p1", "prod_p7", "epilogue_cmult",
                 "arith12", "shfl_p2", "group3_p7", "group3_p3", "group3_p2",
                 "group2_p1", "group1_p0")
#: The file ``--dump`` writes the headline's modular pass into.
MOD32_FIXTURE = "sass_fixture_mod32.txt"


def main(argv=None) -> int:
    import torch

    from . import probe_stages, probe_vpu

    argv = sys.argv[1:] if argv is None else argv
    sass = library_sass()
    unknown = sorted({i.opcode for ins in sass.values() for i in ins
                      if classify(i.opcode) == "unknown"})
    out = {"unknown_opcodes": unknown,
           "headline": {k: {kk: summarize(vv) for kk, vv in v.items()}
                        for k, v in audit_headline(sass).items()},
           "int64_inverse_static": {
               form: summarize(audit_pass_static(True, sass, True, mod))
               for form, mod in (("limb64", False), ("mod64", True))},
           "int32_static": {
               f"{d} {form}": summarize(audit_pass_static(False, sass, inv,
                                                          mod))
               for d, inv in (("fwd", False), ("inv", True))
               for form, mod in (("int32", False), ("mod32", True))},
           "stages": {name: summarize(audit_stage(name, sass))
                      for name in probe_stages.STEPS}}
    if "--probes" in argv:
        out["probes"] = {
            body: dict(summarize(audit_probe_chain(body, sass).scaled(
                CHAINS_PER_THREAD)), source_ops=probe_vpu.BODIES[body].ops)
            for body in probe_vpu.INT32_BODIES}
        for body in probe_vpu.INT16_BODIES:
            ins = chain_function(body, sass, int16=True)
            out["probes"][f"int16 {body}"] = dict(
                summarize(count_loop(ins, chain_loop(ins)).scaled(
                    chains_per_thread(body, int16=True))),
                loop_opcodes=loop_opcodes(ins),
                source_ops=probe_vpu.per_register(body, torch.int16))
    if "--dump" in argv:
        where = Path(argv[argv.index("--dump") + 1])
        where.mkdir(parents=True, exist_ok=True)
        steps = [stage_pattern(s.index, s.order, s.wide)
                 for s in map(probe_stages.STEPS.get, FIXTURE_STEPS)]
        (where / "sass_fixture.txt").write_text(fixture_text(
            library_text(), [chain_pattern(probe_vpu.BODIES["mixed7"].index),
                   pass_pattern(False), *steps]))
        (where / MOD32_FIXTURE).write_text(fixture_text(
            library_text(), [pass_pattern(False, mod=True),
                             pass_pattern(False, mod=True, skew=True)]))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
