"""The compiled-code audit of the port (intfftk_tpu_torch.tools.audit_sass)
on the CPU: the parser, the classifier and the loop finders against a SASS
text captured from the built kernel library on an NVIDIA H100's toolkit
(tests/data/sass_fixture.txt: ``audit_sass --dump``, the functions the
tests read, encoding columns cut; tests/data/sass_fixture_mod32.txt: the
headline's pass in the form it takes, products modulo 2^32), and the
instruction-counted bound of ``utils.roofline`` from it.  The counts below
were read off those dumps."""

import re
from pathlib import Path

import pytest

from intfftk_tpu_torch.config import FFTConfig
from intfftk_tpu_torch.tools import audit_sass as au
from intfftk_tpu_torch.tools import probe_stages as ps
from intfftk_tpu_torch.tools import probe_vpu as pv
from intfftk_tpu_torch.utils import roofline as rf

FIXTURE = Path(__file__).resolve().parent / "data" / "sass_fixture.txt"
MOD32 = FIXTURE.with_name(au.MOD32_FIXTURE)


@pytest.fixture(scope="module")
def sass():
    return au.parse_sass(FIXTURE.read_text())


@pytest.fixture(scope="module")
def sass_mod32():
    return au.parse_sass(MOD32.read_text())


LOOP = """\
		Function : _Z4loopPii
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x00000a00ff017b82 */
                                                                 /* 0x000fe20000000800 */
        /*0010*/                   IMAD.MOV.U32 R0, RZ, RZ, RZ ; /* 0x0 */
        /*0020*/                   IMAD R2, R2, R2, 0x3 ;        /* 0x0 */
        /*0030*/                   VIADD R0, R0, 0x1 ;           /* 0x0 */
        /*0040*/                   ISETP.GE.AND P0, PT, R0, UR4, PT ; /* 0x0 */
        /*0050*/              @!P0 BRA 0x20 ;                    /* 0x0 */
        /*0060*/                   STG.E desc[UR6][R4.64], R2 ;  /* 0x0 */
        /*0070*/                   EXIT ;                        /* 0x0 */
        /*0080*/                   BRA 0x80;                     /* 0x0 */
        /*0090*/                   NOP;                          /* 0x0 */
"""


def test_parser_on_a_hand_written_loop():
    """Three instructions of work and the loop's own three: the span runs
    from the backward branch's target to the branch; the trap branch to
    itself after EXIT closes no loop."""
    funcs = au.parse_sass(LOOP)
    assert list(funcs) == ["_Z4loopPii"]
    ins = funcs["_Z4loopPii"]
    assert [i.addr for i in ins] == list(range(0, 0xa0, 0x10))
    assert ins[5] == au.Instr(0x50, "@!P0", "BRA", "0x20")
    assert ins[1].opcode == "IMAD.MOV.U32" and ins[9].opcode == "NOP"
    assert au.loops(ins) == [(0x20, 0x50)]
    counts = au.count_loop(ins)
    assert counts == {"alu": {"IMAD": 1},
                      "loop": {"VIADD": 1, "ISETP": 1, "BRA": 1}}
    assert counts.total() == 4 and counts.total("alu") == 1
    assert counts.scaled(2) == {"alu": 0.5, "loop": 1.5, "fma_pipe": 0.5,
                                "alu_pipe": 0.0}
    with pytest.raises(ValueError, match="no loop"):
        au.count_loop(ins[6:])


PACKED = """\
		Function : _ZN12_GLOBAL__N_119packed_chain_kernelILi12EEEvPKjPjix
        /*0000*/                   LDG.E R2, desc[UR4][R6.64] ;
        /*0010*/                   LDG.E R3, desc[UR4][R8.64] ;
        /*0020*/                   VIADD.16x2 R2, R2, R2 ;
        /*0030*/                   SHF.L.W.U32.HI R3, R3, 0x1, R3 ;
        /*0040*/                   LOP3.LUT R3, R3, 0xfffefffe, RZ, 0xc0, !PT ;
        /*0050*/                   UIADD3 UR5, UR5, 0x1, URZ ;
        /*0060*/                   ISETP.LE.AND P0, PT, R4, UR5, PT ;
        /*0070*/              @!P0 BRA 0x20 ;
        /*0080*/                   STG.E desc[UR4][R6.64], R2 ;
        /*0090*/                   IADD3 R0, R0, 0x108, RZ ;
        /*00a0*/                   ISETP.GE.AND P1, PT, R0, R5, PT ;
        /*00b0*/              @!P1 BRA 0x0 ;
        /*00c0*/                   EXIT ;
"""


def test_packed_chain_kernel_loop():
    """The packed chains' kernel runs its K loop inside its loop over
    blocks: the chain's loop is the inner one, found by name, counted and
    listed with its opcodes' modifiers."""
    sass = au.parse_sass(PACKED)
    name = au.find_function(sass, au.chain_pattern(12, "p"))
    ins = sass[name]
    assert au.loops(ins) == [(0x20, 0x70), (0x0, 0xb0)]
    assert au.chain_loop(ins) == (0x20, 0x70)
    assert au.loop_opcodes(ins) == {
        "VIADD.16x2": 1, "SHF.L.W.U32.HI": 1, "LOP3.LUT": 1, "UIADD3": 1,
        "ISETP.LE.AND": 1, "BRA": 1}
    assert au.chain_loop_sizes(sass) == {(12, "p"): 6}
    assert not any(re.search(au.chain_pattern(12, "j"), n) for n in sass)
    assert (au.chains_per_thread("add", int16=True),
            au.chains_per_thread("add_vadd2", int16=True),
            au.chains_per_thread("add_unpacked", int16=True),
            au.chains_per_thread("add")) == (16, 16, 8, 8)


def test_a_way_back_from_a_block_after_the_body_is_no_loop():
    """The compiler lays the divergent path of a shuffle after EXIT and
    branches back into the body: a backward branch over an EXIT."""
    text = LOOP.replace("BRA 0x80;", "BRA 0x30 ;")
    ins = au.parse_sass(text)["_Z4loopPii"]
    assert au.loops(ins) == [(0x20, 0x50)]


def test_classifier():
    for op, cls in [("IADD3", "alu"), ("IMAD.WIDE", "alu"),
                    ("LOP3.LUT", "alu"), ("SHF.R.S32.HI", "alu"), ("ISETP.GE.AND", "alu"),
                    ("SEL", "alu"), ("VIADD", "alu"), ("LEA.HI", "alu"),
                    ("IMAD.MOV.U32", "move"), ("MOV", "move"),
                    ("SHFL.BFLY", "move"), ("PRMT", "move"), ("S2R", "move"),
                    ("LDS", "memory"), ("STS.64", "memory"),
                    ("LDG.E.CONSTANT", "memory"), ("STG.E", "memory"),
                    ("LDC", "memory"), ("BAR.SYNC.DEFER_BLOCKING", "barrier"),
                    ("BRA", "control"), ("BSSY", "control"),
                    ("WARPSYNC.ALL", "control"), ("EXIT", "control"),
                    ("ULDC", "uniform"), ("UMOV", "uniform"),
                    ("UIADD3", "uniform"), ("FROB", "unknown")]:
        assert au.classify(op) == cls, op
    assert set(au.CLASSES) >= {"alu", "move", "memory", "barrier", "control",
                               "uniform", "loop", "unknown"}


def test_every_opcode_of_the_fixture_has_a_class(sass):
    """An opcode in no class would be left out of a bound silently."""
    unknown = sorted({i.opcode for ins in sass.values() for i in ins
                      if au.classify(i.opcode) == "unknown"})
    assert unknown == []
    assert sum(map(len, sass.values())) > 4000


def test_fixture_functions(sass):
    assert len(sass) == 2 + len(au.FIXTURE_STEPS)
    assert FIXTURE.stat().st_size < 700_000
    au.find_function(sass, au.chain_pattern(pv.BODIES["mixed7"].index))
    au.find_function(sass, au.pass_pattern(False))
    for step in au.FIXTURE_STEPS:
        s = ps.STEPS[step]
        au.find_function(sass, au.stage_pattern(s.index, s.order, s.wide))
    with pytest.raises(KeyError, match="0 functions"):
        au.find_function(sass, au.pass_pattern(True))
    with pytest.raises(KeyError, match="functions match"):
        au.find_function(sass, "stage_loop_kernel")


def test_mod32_fixture_functions(sass_mod32):
    """The second fixture holds the headline's pass modulo 2^32 alone: the
    modular pattern names it, the exact one does not, and every opcode
    has a class."""
    assert len(sass_mod32) == 1
    assert MOD32.stat().st_size < 700_000
    au.find_function(sass_mod32, au.pass_pattern(False, mod=True))
    with pytest.raises(KeyError, match="0 functions"):
        au.find_function(sass_mod32, au.pass_pattern(False))
    assert not [i.opcode for ins in sass_mod32.values() for i in ins
                if au.classify(i.opcode) == "unknown"]


def _loop_opcodes(sass, mod):
    """{opcode: count per butterfly} of the headline pass's largest group
    loop (``audit_pass_static``'s span)."""
    ins = sass[au.find_function(sass, au.pass_pattern(False, mod=mod))]
    span, tasks = au.butterfly_loop(ins, 16)
    out = {}
    for i in ins:
        if span[0] <= i.addr <= span[1]:
            out[i.opcode] = out.get(i.opcode, 0) + 1 / (12 * tasks)
    return out


@pytest.mark.parametrize("form,want", [
    ("int32", (122.917, 95.167, 67.667, 35.583)),
    ("mod32", (118.917, 90.75, 60.917, 38.25)),
])
def test_headline_pass_static_by_form(sass, sass_mod32, form, want):
    """Per butterfly of the headline pass's largest group loop (issued,
    alu, ALU pipe, FMA pipe), in both product forms: modulo 2^32, with the
    left shift of each product folded into the twiddle, the loop issues
    4 fewer instructions and 6.75 fewer on the ALU pipe, some moved to the
    FMA pipe: the 64-bit products (IMAD.WIDE) become 32-bit IMADs, the
    64-bit floor shifts (SHF.R.S64) go, and of the wrap's left shifts
    (SHF.L.U32) 3.667 of 9.333 go."""
    mod = form == "mod32"
    per = au.summarize(au.audit_pass_static(
        False, sass_mod32 if mod else sass, mod=mod))
    assert (per["issued"], per["alu"], per["alu_pipe"],
            per["fma_pipe"]) == want
    ops = _loop_opcodes(sass_mod32 if mod else sass, mod)
    got = {k: round(ops.get(k, 0.0), 3)
           for k in ("IMAD.WIDE", "SHF.R.S64", "SHF.L.U32", "IMAD")}
    assert got == ({"IMAD.WIDE": 1.167, "SHF.R.S64": 0.0, "SHF.L.U32": 5.667,
                    "IMAD": 20.583} if mod else
                   {"IMAD.WIDE": 7.833, "SHF.R.S64": 3.333,
                    "SHF.L.U32": 9.333, "IMAD": 11.417})


def test_chain_count(sass):
    """mixed7: 7 source ops are 4 instructions per iteration and chain
    (LOP3, IMAD, SHF, IMAD), 8 chains per trip, 3 of the loop's own."""
    counts = au.audit_probe_chain("mixed7", sass)
    assert counts.total("alu") == 4 * au.CHAINS_PER_THREAD
    assert counts["loop"] == {"UIADD3": 1, "ISETP": 1, "BRA": 1}
    assert set(counts["alu"]) == {"LOP3", "IMAD", "SHF"}
    assert au.issued(counts.scaled(au.CHAINS_PER_THREAD)) == 4.0
    assert au.chain_loop_sizes(sass) == {(6, "j"): 35}


#: Instructions per butterfly of each fixture step, read off the dump:
#: (issued, alu, memory + barrier).
STAGE_COUNTS = {
    "prod_p0": (31.75, 23.75, 8.0),
    "prod_p1": (53.5, 41.0, 8.5),
    "prod_p7": (76.0, 56.0, 11.0),
    "epilogue_cmult": (49.5, 36.5, 13.0),
    "arith12": (30.0, 30.0, 0.0),
    "shfl_p2": (136.0, 101.0, 11.0),
    "group3_p7": (41.917, 37.5, 4.0),
    "group3_p3": (40.0, 34.917, 3.833),
    "group3_p2": (31.25, 28.583, 2.667),
    "group2_p1": (29.5, 25.5, 4.0),
    "group1_p0": (35.0, 27.0, 8.0),
}


@pytest.mark.parametrize("step", list(STAGE_COUNTS))
def test_stage_counts(sass, step):
    per = au.summarize(au.audit_stage(step, sass))
    assert (per["issued"], per["alu"], per["mem"]) == STAGE_COUNTS[step]
    assert per["other"] == 0


def test_loop_finders(sass):
    """The butterfly loop is the nested loop with the most shared-memory
    stores: one butterfly per trip at order 7, four where the compiler
    unrolled order 0; a group step's loop stores 2 x 2^R words per task
    (16 at R = 3: twelve butterflies); a register step's loop is its k
    loop; the pass's largest group loop is found the same way."""
    def ins(step):
        s = ps.STEPS[step]
        return sass[au.find_function(sass, au.stage_pattern(s.index, s.order,
                                                            s.wide))]

    assert au.butterfly_loop(ins("prod_p7"))[1] == 1
    assert au.butterfly_loop(ins("prod_p0"))[1] == 4
    assert au.butterfly_loop(ins("shfl_p2"))[1] == 1
    assert au.butterfly_loop(ins("group3_p7"), 16)[1] == 1
    assert au.butterfly_loop(ins("group2_p1"), 8)[1] == 1
    assert au.butterfly_loop(ins("group1_p0"), 4)[1] == 1
    with pytest.raises(ValueError, match="units of 16"):
        au.butterfly_loop(ins("group2_p1"), 16)
    span = au.register_loop(ins("arith12"))
    body = [i for i in ins("arith12") if span[0] <= i.addr <= span[1]]
    assert len(body) == 123 and not any(
        i.opcode.startswith(("LD", "ST")) for i in body)
    with pytest.raises(ValueError, match="shared"):
        au.butterfly_loop(ins("arith12"))
    static = au.summarize(au.audit_pass_static(False, sass))
    assert (static["issued"], static["alu"], static["loop"]) == (
        122.917, 95.167, 0.25)


def test_audit_kernel_ops_from_the_fixture(sass):
    """The 64k headline, 256 x 256: each factor is the groups (7, 3), (4, 3)
    and (1, 2), half a butterfly per sample and stage, and one product per
    sample.  The fixture holds ``group3_p7``, which stands for every group
    of three multiplying stages, and the tails."""
    cfg = FFTConfig(n=1 << 16, mode="scaled", rounding="round",
                    data_width=16, twiddle_width=16)
    assert au.group_split(8) == [(7, 3), (4, 3), (1, 2)]
    alu, move = rf.audit_kernel_ops(cfg, 256, 256, sass=sass)
    g3, g2, g1, epi = (au.audit_stage(s, sass) for s in (
        "group3_p7", "group2_p1", "group1_p0", "epilogue_cmult"))
    assert alu == pytest.approx(
        2 * (6 * g3["alu"] + 2 * g2["alu"]) / 2 + epi["alu"] / 2)
    assert alu + move == pytest.approx(
        2 * (6 * au.issued(g3) + 2 * au.issued(g2)) / 2
        + au.issued(epi) / 2) == pytest.approx(335.25)
    one = rf.audit_kernel_ops(FFTConfig(n=4096), 4096, sass=sass)
    assert sum(one) == pytest.approx(
        (9 * au.issued(g3) + 3 * au.issued(au.audit_stage("group3_p2", sass)))
        / 2)
    # 1024 rows: (9, 3), (6, 3), (3, 3) down to order 1, and the order-0 tail
    assert au.group_split(10) == [(9, 3), (6, 3), (3, 3), (0, 1)]
    assert sum(rf.audit_kernel_ops(FFTConfig(n=1024), 1024, sass=sass)) == \
        pytest.approx((6 * au.issued(g3) + 3 * au.issued(au.audit_stage(
            "group3_p3", sass)) + au.issued(g1)) / 2)
    assert au.group_step_for(4, 3, False, sass) == "group3_p7"
    assert au.group_step_for(3, 3, False, sass) == "group3_p3"
    assert au.group_step_for(2, 3, False, sass) == "group3_p2"
    assert au.group_step_for(1, 2, False, sass) == "group2_p1"
    # with 2-D tables every stage multiplies: the form with the most
    # products stands for the tail, and failing that the nearest below it
    assert au.group_step_for(2, 3, False, sass, two_d=True) == "group3_p7"
    assert au.group_step_for(0, 1, False, sass, two_d=True) == "group1_p0"
    with pytest.raises(KeyError, match="int64"):
        au.group_step_for(7, 3, True, sass)
    with pytest.raises(NotImplementedError, match="forward"):
        rf.audit_kernel_ops(cfg, 256, 256, inverse=True, sass=sass)
    with pytest.raises(ValueError, match="bad factors"):
        rf.audit_kernel_ops(cfg, 256, 128, sass=sass)
    with pytest.raises(KeyError):              # no int64 kernel in the fixture
        rf.audit_kernel_ops(FFTConfig(n=4096, mode="unscaled",
                                      data_width=32), 4096, sass=sass)


def test_instruction_bound(sass):
    """The ceiling in instructions: the better mixed chain's source ops/s
    times its instructions per source op (4 / 7)."""
    measured = {"mixed7_ops_per_s": 52.5e12, "stagemix10_ops_per_s": 43e12}
    rate = rf.instruction_rate(measured, sass)
    assert rate == pytest.approx(52.5e12 * 4 / 7)
    cost = rf.KernelCost(int_ops=1.0, hbm_bytes=1.0, instructions=566.0 * 1e6)
    assert cost.instruction_bound(rate) == pytest.approx(566e6 / 30e12)
    assert rf.KernelCost(1.0, 1.0).instructions is None


def test_summarize_keys():
    per = {"alu": 10.0, "move": 2.0, "memory": 3.0, "barrier": 1.0,
           "control": 4.0, "uniform": 1.0, "loop": 3.0}
    assert au.summarize(per, 2) == {
        "alu": 5.0, "move": 1.0, "mem": 2.0, "other": 0.0, "control": 2.0,
        "uniform": 0.5, "loop": 1.5, "issued": 10.5, "fma_pipe": 0.0,
        "alu_pipe": 0.0}


def test_fixture_text_keeps_the_parse(sass):
    """Cutting the encoding columns and the padding changes no instruction;
    a second cut changes nothing at all."""
    text = FIXTURE.read_text()
    again = au.fixture_text(text, ["."])
    assert again == text
    both = au.fixture_text(LOOP, ["loop"])
    assert au.parse_sass(both) == au.parse_sass(LOOP)
    assert "0x00000a00ff017b82" not in both


def test_the_tool_needs_cuobjdump():
    import shutil

    if shutil.which("cuobjdump") or shutil.which("nvcc"):
        pytest.skip("this machine has the CUDA toolkit")
    with pytest.raises(RuntimeError, match="not found"):
        au.find_cuobjdump()
    with pytest.raises(RuntimeError, match="not found"):
        au.library_sass()


def test_ab_paths_usage():
    """The A/B tool takes two roots; anything else prints its usage."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "ab_torch_paths",
        Path(__file__).resolve().parents[1] / "tools" / "ab_torch_paths.py")
    ab_paths = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab_paths)
    assert ab_paths.main([]) == 2
    assert ab_paths.main(["one"]) == 2


def test_cluster_kernel_opcodes_classified():
    """The opcodes the whole four-step's cluster kernel brings (the cluster
    barrier, its error barrier, the fused add-min/max) have a class."""
    assert [au.classify(op) for op in ("UCGABAR_ARV", "UCGABAR_WAIT",
                                       "CGAERRBAR", "VIADDMNMX.U32")] == [
        "barrier", "barrier", "control", "alu"]
