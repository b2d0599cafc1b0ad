"""Roofline accounting for the integer FFT kernels.

Counterpart of ``intfftk_tpu/utils/roofline.py``: a cost model per kernel
(vector integer ops and device-memory bytes) against the card's two
ceilings, which gives the least time the card could take for the same work
and the share of it a measured time reaches.  The ceilings come from
``tools.probe_vpu.same_session_ceilings`` in the session that uses them
(the integer rate measured, the memory rate the card's own clock x bus
width): this module records none.

Two numerators stand side by side.  The source-level one is a hand count
(``OPS_PER_SAMPLE_STAGE``) over the probe chains' source-level ops/s.  The
instruction-counted one is ``audit_kernel_ops``: where the JAX module's
function of that name counts a traced jaxpr, this one counts the SASS the
card runs (``tools.audit_sass``), stage by stage, over the instructions/s
of the same chain that sets the ceiling (``instruction_rate``), so
numerator and denominator come from one counter.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """Static cost of one kernel invocation."""

    int_ops: float        # vector int32 operations
    hbm_bytes: float      # bytes moved between device memory and the SMs
    #: SASS instructions its stages issue (``audit_kernel_ops`` x samples),
    #: where they were counted
    instructions: float | None = None

    def time_bound(self, ceilings) -> float:
        """Lower-bound runtime (s): max of compute and memory time.

        ``ceilings``: an ``(ops/s, bytes/s)`` pair from
        ``tools.probe_vpu.same_session_ceilings()``."""
        ops_ceil, bw_ceil = ceilings
        return max(self.int_ops / ops_ceil, self.hbm_bytes / bw_ceil)

    def instruction_bound(self, instr_per_s: float) -> float:
        """Least time (s) to issue ``instructions`` at ``instr_per_s``
        (``instruction_rate``)."""
        return self.instructions / instr_per_s


#: Vector ops per complex sample per stage of the scaled/round 16x16-bit
#: stage body.  Hand count per butterfly (= 2 samples): add/sub with 3-op
#: exact rounding on 4 component arrays = 12 ops; twiddle cmult on the
#: product half = 4 mul + 2 add + 2 renorm shift + 4 wrap = 12 ops -> 24
#: ops / 2 samples = 12.  This flat constant charges 12 to every stage,
#: though the twiddle-order 0/1 stages have no multiplier (6-7 ops), and it
#: counts 32-bit ops: the int64 tile of the wide path does 64-bit sums and
#: 128-bit products for each.
OPS_PER_SAMPLE_STAGE = 12.0


def fft_cost(n: int, batch: int, fused: bool = True,
             ops_per_sample_stage: float = OPS_PER_SAMPLE_STAGE
             ) -> KernelCost:
    """Cost of a batched n-point integer FFT.

    ops_per_sample_stage: vector ops per complex sample per stage (see
    ``OPS_PER_SAMPLE_STAGE``).  ``fused=True``: data crosses device memory
    once each way (the single-pass kernel); ``False``: once per stage each
    way (the staged eager path).
    """
    stages = int(math.log2(n))
    samples = n * batch
    ops = samples * stages * ops_per_sample_stage
    passes = 2 if fused else 2 * stages
    hbm = samples * 8 * passes          # int32 re+im per direction
    return KernelCost(int_ops=ops, hbm_bytes=hbm)


def large_fft_cost(n: int, batch: int,
                   ops_per_sample_stage: float = OPS_PER_SAMPLE_STAGE,
                   itemsize: int = 4, crossings: int = 2) -> KernelCost:
    """Cost of the large-n pipeline (LargeFFTPlan).

    ``crossings``: device-memory crossings per complex component: 2 is the
    function's floor (data in once, out once), whatever the two launches of
    the split pipeline reread; 4 counts those too.  Each crossing moves
    2*itemsize bytes per complex sample (itemsize 2 on int16 blocks, 4 on
    int32, 8 on int64).  Table reads are ignored.  Compute: every one of
    the log2(n) stages, plus one epilogue complex multiply (counted as one
    extra stage).
    """
    stages = int(math.log2(n))
    samples = n * batch
    ops = samples * (stages + 1) * ops_per_sample_stage
    return KernelCost(int_ops=ops,
                      hbm_bytes=samples * 2 * itemsize * crossings)


def roofline_fraction(measured_s: float, cost: KernelCost,
                      ceilings) -> float:
    """Achieved fraction of the roofline bound (1.0 = at the ceiling);
    ``ceilings`` as ``KernelCost.time_bound``."""
    return cost.time_bound(ceilings) / measured_s


def audit_kernel_ops(cfg, n1: int, n2: int = 1, inverse: bool = False,
                     sass: dict | None = None) -> tuple[float, float]:
    """``(alu_instr_per_sample, move_instr_per_sample)`` of a transform of
    n1 x n2 points through the factor pass (``n2 = 1``: one pass, no
    inter-factor product), counted from the compiled stage kernels
    (``tools.audit_sass.audit_transform``): every stage of both factors at
    its twiddle order, and the inter-factor product.  ``alu``: integer
    arithmetic, compares and selects; ``move``: everything else the stages
    issue (register moves and shuffles, shared-memory and table loads and
    stores, barriers, branches inside the body, the uniform datapath).
    Their sum is what ``instruction_bound`` divides.  An output wider than
    32 bits is counted on the int64 tile's kernels.  The probe holds the
    forward stages; ``inverse`` raises NotImplementedError.  ``sass``: a
    parsed dump (``audit_sass.parse_sass``), by default the built
    library's."""
    from ..tools import audit_sass

    if inverse:
        raise NotImplementedError("the stage probe holds the forward "
                                  "stages only")
    if n1 * n2 != cfg.n:
        raise ValueError(f"bad factors {n1}x{n2} for n={cfg.n}")
    per = audit_sass.audit_transform(n1, n2, cfg.output_width > 32, sass)
    alu = per.get("alu", 0.0)
    return alu, audit_sass.issued(per) - alu


def instruction_rate(measured: dict, sass: dict | None = None) -> float:
    """Instructions per second of the chain that sets the integer ceiling
    (``tools.probe_vpu.ceilings_from``): its measured source-level ops/s
    times its compiled instructions per source op."""
    from ..tools import audit_sass, probe_vpu

    body = max(("mixed7", "stagemix10"),
               key=lambda b: measured[probe_vpu.BODIES[b].key])
    per = audit_sass.audit_probe_chain(body, sass).scaled(
        audit_sass.CHAINS_PER_THREAD)
    return (measured[probe_vpu.BODIES[body].key] * audit_sass.issued(per)
            / probe_vpu.BODIES[body].ops)
