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
* ``audit_probe_chain(body)``: instructions per iteration and chain of
  ``chain_kernel<body>``: the ceiling's denominator;
* ``audit_stage(step)``: instructions per butterfly of
  ``stage_loop_kernel<step>`` (``csrc/probe_stages.cu``): the numerator by
  twiddle order.  The count is clean there, because the order is a
  template parameter: ``fused_pass_kernel``'s own butterfly loop holds the
  order-0, order-1 and multiplying forms behind run-time branches, so its
  static span over-counts every stage;
* ``audit_headline()``: both, for the 64k headline (256 x 256): the static
  span of the butterfly loop of ``fused_pass_kernel<int16, int16, int32,
  false, false>``, and the per-stage sum of ``audit_stage`` over the 8 + 8
  stages plus the epilogue product, per sample; the same for the int64
  instantiation;
* ``summarize(counts, samples)``: per-sample numbers by class.

Usage, on a machine with the card's toolkit (builds the library first):

    python -m intfftk_tpu_torch.tools.audit_sass [--probes] [--dump DIR]

prints one JSON dict; ``--probes`` adds the chain bodies, ``--dump`` writes
the SASS text of the functions the audit reads.
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
    VABSDIFF4 VIMNMX IMNMX LEA IABS FLO POPC BREV BMSK SGXT PLOP3 PSETP P2R
    R2P I2I I2IP IDP IDP4A F2I I2F I2FP F2F F2FP FADD FMUL FFMA FSETP FSEL
    FMNMX MUFU HADD2 HMUL2 HFMA2 HSETP2 HMNMX2 DADD DMUL DFMA DSETP FCHK
    FRND""".split())
_MOVE = frozenset("""
    MOV PRMT SHFL S2R CS2R R2UR S2UR MOVM VOTE VOTEU MATCH REDUX
    """.split())
_MEMORY = frozenset("""
    LD ST LDG STG LDS STS LDL STL LDC LDSM STSM ATOM ATOMS ATOMG RED CCTL
    CCTLL MEMBAR LDGSTS UBLKCP UTMALDG UTMASTG""".split())
_BARRIER = frozenset(["BAR", "SYNCS", "ARRIVES"])
_CONTROL = frozenset("""
    BRA BRX JMP JMX CALL RET EXIT BSSY BSYNC BREAK BMOV WARPSYNC NOP YIELD
    NANOSLEEP DEPBAR LDGDEPBAR ERRBAR KILL BPT RPCMOV ACQBULK ENDCOLLECTIVE
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


def butterfly_loop(instrs: list[Instr]) -> tuple[tuple[int, int], int]:
    """The butterfly loop of a stage kernel or of the factor pass, and the
    butterflies one trip of it runs: of ``inner_loops`` the one with the
    most shared-memory stores (a stage stores four words per butterfly;
    where the compiler unrolled the loop, its remainder loops have
    fewer)."""
    inner = inner_loops(instrs)
    if not inner:
        raise ValueError("no nested loop: not a stage kernel")
    best = max(inner, key=lambda s: _stores(_span(instrs, s)))
    stores = _stores(_span(instrs, best))
    if stores == 0 or stores % 4:
        raise ValueError(f"the nested loop stores {stores} words to shared "
                         f"memory: not a whole number of butterflies")
    return best, stores // 4


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
    """``chain_kernel<index, T>``: T = "j" (uint32_t) or "t" (uint16_t)."""
    return rf"chain_kernelILi{index}E{letter}E"


def stage_pattern(index: int, order: int, wide: bool = False) -> str:
    """``stage_loop_kernel<index, order, V>``: V int32_t, or int64_t."""
    return rf"stage_loop_kernelILi{index}ELi{order}E{'l' if wide else 'i'}E"


def pass_pattern(wide: bool = False) -> str:
    """The forward 1-D-table instantiation of ``fused_pass_kernel``: int16
    blocks on the int32 tile (the 64k headline), or int64 on int64."""
    return r"fused_pass_kernelI" + ("lll" if wide else "ssi") + "Lb0ELb0EE"


def chain_loop_sizes(sass: dict) -> dict:
    """{(body index, storage letter): instructions in the chain loop} of
    every compiled chain kernel: the whole span, the loop's own included."""
    out = {}
    for name, ins in sass.items():
        m = re.search(r"chain_kernelILi(\d+)E(\w)E", name)
        if m and loops(ins):
            out[int(m.group(1)), m.group(2)] = count_loop(ins).total()
    return out


# ---------------------------------------------------------------- the audits

#: Independent chains per thread of ``chain_kernel`` (``csrc/probe.cu``).
CHAINS_PER_THREAD = 8
#: Samples per thread and trip of a register step (``csrc/probe_stages.cu``).
SAMPLES_PER_TRIP = 8


def audit_probe_chain(body: str, sass: dict | None = None) -> Counts:
    """Instructions of one trip of ``chain_kernel<body>``'s loop by class:
    ``CHAINS_PER_THREAD`` chains' worth (divide by it for instructions per
    iteration and chain)."""
    from . import probe_vpu

    sass = library_sass() if sass is None else sass
    b = probe_vpu.BODIES[body]
    return count_loop(sass[find_function(sass, chain_pattern(b.index))])


def audit_stage(step: str, sass: dict | None = None) -> dict:
    """Instructions per butterfly (two samples) of
    ``stage_loop_kernel<step>`` by class, as {class: count}, from its
    butterfly loop; a register step's loop is its k loop."""
    from . import probe_stages

    sass = library_sass() if sass is None else sass
    s = probe_stages.STEPS[step]
    index = probe_stages.kernel_index(step, probe_stages.probe_config())
    ins = sass[find_function(sass, stage_pattern(index, s.order, s.wide))]
    if s.in_registers:
        return count_loop(ins, register_loop(ins)).scaled(
            SAMPLES_PER_TRIP / 2)
    span, butterflies = butterfly_loop(ins)
    return count_loop(ins, span).scaled(butterflies)


def audit_pass_static(wide: bool = False, sass: dict | None = None) -> dict:
    """Instructions per butterfly of ``fused_pass_kernel``'s own butterfly
    loop by class: a static count, which holds all three twiddle forms."""
    sass = library_sass() if sass is None else sass
    ins = sass[find_function(sass, pass_pattern(wide))]
    span, butterflies = butterfly_loop(ins)
    return count_loop(ins, span).scaled(butterflies)


def stage_step_for(order: int, wide: bool, sass: dict) -> str:
    """The production step of ``sass`` that stands for twiddle order
    ``order``: orders 0 and 1 have their own form; every order >= 2
    multiplies by a table entry and differs only in constants, so the
    nearest probed one stands for it."""
    from . import probe_stages

    pre = "prod64_p" if wide else "prod_p"
    have = sorted(s.order for n, s in probe_stages.STEPS.items()
                  if n.startswith(pre) and any(
                      re.search(stage_pattern(s.index, s.order, wide), f)
                      for f in sass))
    if order in have:
        return f"{pre}{order}"
    near = min((p for p in have if p >= 2), key=lambda p: abs(p - order))
    return f"{pre}{near}"


def _add(a: dict, b: dict, times: float = 1.0) -> dict:
    return {c: a.get(c, 0.0) + times * b.get(c, 0.0)
            for c in set(a) | set(b)}


def audit_orders(orders, products: int = 0, wide: bool = False,
                 sass: dict | None = None) -> dict:
    """Instructions per sample by class of forward stages at the twiddle
    ``orders`` (half a butterfly per sample each, from ``audit_stage``)
    and of ``products`` inter-factor products, on the int32 tile or the
    int64 one.  Load, store and reorder of a pass are not in it."""
    sass = library_sass() if sass is None else sass
    total: dict = {}
    for order in orders:
        total = _add(total, audit_stage(
            stage_step_for(order, wide, sass), sass), 0.5)
    epi = "epilogue64_cmult" if wide else "epilogue_cmult"
    return _add(total, audit_stage(epi, sass), 0.5 * products) \
        if products else total


def audit_transform(n1: int, n2: int = 1, wide: bool = False,
                    sass: dict | None = None) -> dict:
    """Instructions per sample by class of a forward transform of n1 x n2
    points through the factor pass: every stage of both factors and, with
    a second factor, the inter-factor product (``audit_orders``)."""
    orders = [q for n in (n1, n2) for q in range(n.bit_length() - 1)]
    return audit_orders(orders, int(n2 > 1), wide, sass)


def audit_headline(sass: dict | None = None) -> dict:
    """The 64k headline (256 x 256) and its int64 twin: per butterfly the
    static span of the pass's own loop, per sample the per-stage sum."""
    sass = library_sass() if sass is None else sass
    out = {}
    for name, wide in (("narrow", False), ("int64", True)):
        out[name] = {
            "static_per_butterfly": audit_pass_static(wide, sass),
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
#: headline pass, and the stage kernels the per-stage sum and the loop
#: finders are tested on.
FIXTURE_STEPS = ("prod_p0", "prod_p1", "prod_p7", "epilogue_cmult",
                 "arith12", "shfl_p2")


def main(argv=None) -> int:
    from . import probe_stages, probe_vpu

    argv = sys.argv[1:] if argv is None else argv
    sass = library_sass()
    unknown = sorted({i.opcode for ins in sass.values() for i in ins
                      if classify(i.opcode) == "unknown"})
    out = {"unknown_opcodes": unknown,
           "headline": {k: {kk: summarize(vv) for kk, vv in v.items()}
                        for k, v in audit_headline(sass).items()},
           "stages": {name: summarize(audit_stage(name, sass))
                      for name in probe_stages.STEPS}}
    if "--probes" in argv:
        out["probes"] = {
            body: dict(summarize(audit_probe_chain(body, sass).scaled(
                CHAINS_PER_THREAD)), source_ops=probe_vpu.BODIES[body].ops)
            for body in probe_vpu.INT32_BODIES}
    if "--dump" in argv:
        where = Path(argv[argv.index("--dump") + 1])
        where.mkdir(parents=True, exist_ok=True)
        steps = [stage_pattern(s.index, s.order, s.wide)
                 for s in map(probe_stages.STEPS.get, FIXTURE_STEPS)]
        (where / "sass_fixture.txt").write_text(fixture_text(
            library_text(), [chain_pattern(probe_vpu.BODIES["mixed7"].index),
                   pass_pattern(False), *steps]))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
