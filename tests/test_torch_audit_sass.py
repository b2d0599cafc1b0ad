"""The compiled-code audit of the port (intfftk_tpu_torch.tools.audit_sass)
on the CPU: the parser, the classifier and the loop finders against a SASS
text captured from the built kernel library on an NVIDIA H100's toolkit
(tests/data/sass_fixture.txt: ``audit_sass --dump``, the functions the
tests read, encoding columns cut), and the instruction-counted bound of
``utils.roofline`` from it.  The counts below were read off that dump."""

from pathlib import Path

import pytest

from intfftk_tpu_torch.config import FFTConfig
from intfftk_tpu_torch.tools import audit_sass as au
from intfftk_tpu_torch.tools import probe_stages as ps
from intfftk_tpu_torch.tools import probe_vpu as pv
from intfftk_tpu_torch.utils import roofline as rf

FIXTURE = Path(__file__).resolve().parent / "data" / "sass_fixture.txt"


@pytest.fixture(scope="module")
def sass():
    return au.parse_sass(FIXTURE.read_text())


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
    assert FIXTURE.stat().st_size < 300_000
    au.find_function(sass, au.chain_pattern(pv.BODIES["mixed7"].index))
    au.find_function(sass, au.pass_pattern(False))
    for step in au.FIXTURE_STEPS:
        s = ps.STEPS[step]
        au.find_function(sass, au.stage_pattern(s.index, s.order, s.wide))
    with pytest.raises(KeyError, match="0 functions"):
        au.find_function(sass, au.pass_pattern(True))
    with pytest.raises(KeyError, match="functions match"):
        au.find_function(sass, "stage_loop_kernel")


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
}


@pytest.mark.parametrize("step", list(STAGE_COUNTS))
def test_stage_counts(sass, step):
    per = au.summarize(au.audit_stage(step, sass))
    assert (per["issued"], per["alu"], per["mem"]) == STAGE_COUNTS[step]
    assert per["other"] == 0


def test_loop_finders(sass):
    """The butterfly loop is the nested loop with the most shared-memory
    stores: one butterfly per trip at order 7, four where the compiler
    unrolled order 0; a register step's loop is its k loop; the pass's own
    loop is found the same way."""
    def ins(step):
        s = ps.STEPS[step]
        return sass[au.find_function(sass, au.stage_pattern(s.index, s.order,
                                                            s.wide))]

    assert au.butterfly_loop(ins("prod_p7"))[1] == 1
    assert au.butterfly_loop(ins("prod_p0"))[1] == 4
    assert au.butterfly_loop(ins("shfl_p2"))[1] == 1
    span = au.register_loop(ins("arith12"))
    body = [i for i in ins("arith12") if span[0] <= i.addr <= span[1]]
    assert len(body) == 123 and not any(
        i.opcode.startswith(("LD", "ST")) for i in body)
    with pytest.raises(ValueError, match="shared"):
        au.butterfly_loop(ins("arith12"))
    static = au.summarize(au.audit_pass_static(False, sass))
    assert (static["issued"], static["alu"], static["loop"]) == (95.0, 70.0,
                                                                 3.0)


def test_audit_kernel_ops_from_the_fixture(sass):
    """The 64k headline, 256 x 256: 2 x (order 0, order 1, 6 multiplying
    orders) half butterflies and one product per sample.  The fixture holds
    orders 0, 1 and 7; order 7 stands for every multiplying order."""
    cfg = FFTConfig(n=1 << 16, mode="scaled", rounding="round",
                    data_width=16, twiddle_width=16)
    alu, move = rf.audit_kernel_ops(cfg, 256, 256, sass=sass)
    assert alu == 2 * (23.75 + 41.0 + 6 * 56.0) / 2 + 36.5 / 2 == 419.0
    assert alu + move == 2 * (31.75 + 53.5 + 6 * 76.0) / 2 + 49.5 / 2 == 566.0
    one = rf.audit_kernel_ops(FFTConfig(n=4096), 4096, sass=sass)
    assert sum(one) == (31.75 + 53.5 + 10 * 76.0) / 2
    assert au.stage_step_for(3, False, sass) == "prod_p7"
    assert au.stage_step_for(1, False, sass) == "prod_p1"
    with pytest.raises(NotImplementedError, match="forward"):
        rf.audit_kernel_ops(cfg, 256, 256, inverse=True, sass=sass)
    with pytest.raises(ValueError, match="bad factors"):
        rf.audit_kernel_ops(cfg, 256, 128, sass=sass)
    with pytest.raises(ValueError):            # no int64 kernel in the fixture
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
