"""The per-stage probe of the port on the CPU: the plain version of every
step (intfftk_tpu_torch.tools.probe_stages.stage_loop_reference) against
the JAX package's own stage function ``_dif_stage_rows`` on jnp arrays (the
same numpy-seeded tile through both, exactly), against the TPU tool's
production step (``tools/probe_stages.py:make_prod_step``) and its op
images; the plain version of the stage group (``group_reference``, the
group steps) against the JAX package's multi-stage bodies
(``_dif_pair_stage_rows``, ``_dif_stage_rows`` and ``_dit_stage_rows``
composed, ``_transform_rows`` for a whole factor through ``group_split``);
the step table, the guards and the refusals.  Tolerance 0 throughout."""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intfftk_tpu.config import FFTConfig as JaxConfig
from intfftk_tpu.ops import intmath as jm
from intfftk_tpu.ops.pallas_fft import (_cmult_plans, _dif_pair_stage_rows,
                                        _dif_stage_rows, _dit_stage_rows,
                                        _pack_tables, _transform_rows)
from intfftk_tpu_torch.convert import config_from_jax as P
from intfftk_tpu_torch.tools import probe_stages as ps

N, B = 256, 8
MODES = {"scaled_round": dict(mode="scaled", rounding="round"),
         "unscaled": dict(mode="unscaled")}


def _tpu_tool():
    """tools/probe_stages.py of the JAX package's repo, loaded by path (the
    directory is no package)."""
    path = Path(__file__).resolve().parents[1] / "tools" / "probe_stages.py"
    spec = importlib.util.spec_from_file_location("tpu_probe_stages", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfg(mode, data_width=16, n=N):
    return JaxConfig(n=n, data_width=data_width, twiddle_width=16,
                     **MODES[mode])


def _tile(p, width, stimulus, seed=0, n=N):
    """A [n, B] tile pair of ``width``-bit values.  "adversarial": column 0
    pairs (max, min) in every butterfly of order p, which drives the
    round-mode difference to +2^(w-1); column 1 is the most-negative value
    throughout (the guarded negate of order 1)."""
    rng = np.random.default_rng(seed)
    lim = 1 << (width - 1)
    xr = rng.integers(-lim, lim, (n, B))
    xi = rng.integers(-lim, lim, (n, B))
    if stimulus == "adversarial":
        high = (np.arange(n) & (1 << p)) != 0
        xr[:, 0] = np.where(high, -lim, lim - 1)
        xi[:, 0] = np.where(high, lim - 1, -lim)
        xr[:, 1] = xi[:, 1] = -lim
    return xr.astype(np.int32), xi.astype(np.int32)


def _jax_stage(cfg, xr, xi, p, k):
    """``_dif_stage_rows`` at twiddle order p, k times: application i at
    the width of stage i, as a pass runs it."""
    w_re, w_im = (jnp.asarray(t) for t in _pack_tables(cfg, False))
    xr, xi = jnp.asarray(xr), jnp.asarray(xi)
    for i in range(k):
        dw = cfg.stage_input_width(i) + 1 - cfg.scale
        cplan = jm.CmultPlan(data_width=dw, twiddle_width=cfg.twiddle_width,
                             shift=cfg.twiddle_shift,
                             out_width=dw) if p >= 2 else None
        xr, xi = _dif_stage_rows(xr, xi, cfg, i, p, w_re, w_im, cplan)
    return np.asarray(xr), np.asarray(xi)


def _port(step, cfg, xr, xi, k, **kw):
    pc = P(cfg)
    out = ps.stage_loop(step, torch.from_numpy(xr), torch.from_numpy(xi), k,
                        pc, ps.stage_tables(pc, "cpu"), **kw)
    return [t.numpy() for t in out]


@pytest.mark.parametrize("stimulus", ["random", "adversarial"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("p", ps.PROD_ORDERS)
def test_prod_reference_equals_jax_stage(p, mode, k, stimulus):
    cfg = _cfg(mode)
    xr, xi = _tile(p, 16, stimulus, seed=p * 8 + k)
    want = _jax_stage(cfg, xr, xi, p, k)
    before = ps.stage_loop.launches
    got = _port(f"prod_p{p}", cfg, xr, xi, k)
    assert ps.stage_loop.launches == before      # the CPU launches nothing
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("p", ps.PROD_ORDERS)
def test_prod_reference_equals_tpu_tool_step(p):
    """``make_prod_step`` of the TPU tool, on its own config (n = 256,
    scaled/round, 16-bit) and its own stimulus range."""
    cfg = _cfg("scaled_round")
    xr, xi = _tile(p, 15, "random", seed=p)
    tabs = tuple(jnp.asarray(t) for t in _pack_tables(cfg, False))
    want = _tpu_tool().make_prod_step(cfg, p)(tabs, jnp.asarray(xr),
                                              jnp.asarray(xi))
    for g, w in zip(_port(f"prod_p{p}", cfg, xr, xi, 1), want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_int32_min_through_the_guarded_negate():
    """Unscaled 31-bit data: the order-1 difference reaches INT32_MIN, and
    the odd index negates it."""
    cfg = _cfg("unscaled", data_width=31)
    xr, xi = _tile(1, 31, "adversarial")
    xr[:, 2] = np.where((np.arange(N) & 2) != 0, 1 << 30, -(1 << 30))
    want = _jax_stage(cfg, xr, xi, 1, 1)
    got = _port("prod_p1", cfg, xr, xi, 1)
    assert (want[1] == np.iinfo(np.int32).max).any()   # -INT32_MIN, guarded
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("step", [s for s, v in ps.STEPS.items()
                                  if v.variant_of])
def test_variant_reference_is_the_production_stage(step):
    """A variant computes its production step's function: on the CPU both
    run the one plain version."""
    cfg = _cfg("unscaled")
    xr, xi = _tile(ps.STEPS[step].order, 16, "adversarial", seed=3)
    for k in (1, ps.check_k(step, P(cfg))):
        got = _port(step, cfg, xr, xi, k)
        want = _port(ps.STEPS[step].variant_of, cfg, xr, xi, k)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    once = _port(step, cfg, xr, xi, 5, once=True)      # once: k is not read
    assert all(np.array_equal(g, w) for g, w in zip(
        once, _port(ps.STEPS[step].variant_of, cfg, xr, xi, 1)))


@pytest.mark.parametrize("k", [1, 3, 40])
@pytest.mark.parametrize("step", ["arith6", "arith12"])
def test_arith_reference_equals_the_tpu_tool_op_image(step, k):
    """The op images of tools/probe_stages.py:224-234, op for op, on jnp
    int32 arrays."""
    xr, xi = _tile(0, 15, "random", seed=k)
    ar, ai = jnp.asarray(xr), jnp.asarray(xi)
    for _ in range(k):
        sr = (ar + ai + 1) >> 1
        si = (ar - ai + 1) >> 1
        if step == "arith12":
            pr = (sr * 23170 - si * 12540) >> 15
            pi = ((si * 23170 + sr * 12540) >> 15) + 1
            sr, si = (pr << 16) >> 16, (pi << 16) >> 16
        ar, ai = sr, si
    got = _port(step, _cfg("scaled_round"), xr, xi, k)
    np.testing.assert_array_equal(got[0], np.asarray(ar))
    np.testing.assert_array_equal(got[1], np.asarray(ai))


@pytest.mark.parametrize("k", [1, 3])
def test_epilogue_reference_equals_jax_cmult(k):
    """``epilogue_cmult``: the TPU tool's ``cmult_exact(eplan, ...)`` with
    its plan (16-bit data and twiddles, shift 15), against an [n, tc] table
    tiled along B."""
    cfg = _cfg("scaled_round")
    xr, xi = _tile(0, 16, "adversarial", seed=k)
    er, ei = ps.epilogue_table(P(cfg), 4, "cpu")
    eplan = jm.CmultPlan(data_width=16, twiddle_width=16, shift=15,
                         out_width=16)
    wr, wi = (jnp.asarray(np.tile(t.numpy(), (1, B // 4))) for t in (er, ei))
    ar, ai = jnp.asarray(xr), jnp.asarray(xi)
    for _ in range(k):
        ar, ai = jm.cmult_exact(eplan, ar, ai, wr, wi)
    got = _port("epilogue_cmult", cfg, xr, xi, k, epi=(er, ei))
    np.testing.assert_array_equal(got[0], np.asarray(ar))
    np.testing.assert_array_equal(got[1], np.asarray(ai))


def test_roundtrip_reference_moves_and_computes_nothing():
    xr, xi = _tile(7, 16, "random")
    cfg = _cfg("scaled_round")
    one = _port("smem_roundtrip", cfg, xr, xi, 1)
    np.testing.assert_array_equal(one[0][:128], xr[128:])
    np.testing.assert_array_equal(one[1][128:], xi[:128])
    two = _port("smem_roundtrip", cfg, xr, xi, 2)
    assert np.array_equal(two[0], xr) and np.array_equal(two[1], xi)


@pytest.mark.parametrize("step", [s for s, v in ps.STEPS.items() if v.wide])
def test_int64_tile_steps_equal_the_int32_ones(step):
    """On 16-bit data the int64 tile's steps give the int32 tile's bits."""
    cfg = P(_cfg("unscaled"))
    xr, xi = (torch.from_numpy(v) for v in _tile(7, 16, "adversarial"))
    epi = ps.epilogue_table(cfg, 4, "cpu")
    tabs = ps.stage_tables(cfg, "cpu")
    narrow = re.sub(r"64_(?=\d)", "", step).replace("64", "")
    got = ps.stage_loop(step, xr.long(), xi.long(), 3, cfg, tabs, epi)
    want = ps.stage_loop(narrow, xr, xi, 3, cfg, tabs, epi)
    assert got[0].dtype == torch.int64
    assert all(torch.equal(g, w.long()) for g, w in zip(got, want))


GROUP_MODES = dict(MODES, scaled_truncate=dict(mode="scaled",
                                               rounding="truncate"))
#: (top order, stages) of the int32 group steps.
GROUPS = [(s.order, s.stages) for name, s in ps.STEPS.items()
          if name.startswith("group") and not s.wide and not s.variant_of]


def _group_cfg(mode, data_width=16, n=N):
    return JaxConfig(n=n, data_width=data_width, twiddle_width=16,
                     **GROUP_MODES[mode])


def _plan(cfg, s, inverse=False):
    """The product plan of stage index s (``_cmult_plans``): forward at the
    stage's output width, inverse at its input width."""
    in_w = cfg.stage_input_width(s)
    dw = in_w if inverse else in_w + 1 - cfg.scale
    return jm.CmultPlan(data_width=dw, twiddle_width=cfg.twiddle_width,
                        shift=cfg.twiddle_shift, out_width=dw)


def _jax_group(cfg, xr, xi, top, stages, k=1, inverse=False, pair=False):
    """The JAX package's stages of the orders top ... top - stages + 1, one
    after the other, k times: stage index i runs at the width of stage i of
    a pass.  Forward from the top order down (``pair``: two stages through
    ``_dif_pair_stage_rows``), inverse from the bottom order up."""
    w_re, w_im = (jnp.asarray(t) for t in _pack_tables(cfg, inverse))
    xr, xi = jnp.asarray(xr), jnp.asarray(xi)
    orders = list(range(top, top - stages, -1))
    for i in range(k):
        s0 = i * stages
        if pair:
            plans = {s0: _plan(cfg, s0), s0 + 1: _plan(cfg, s0 + 1)}
            xr, xi = _dif_pair_stage_rows(xr, xi, cfg, s0, top, w_re, w_im,
                                          plans)
            continue
        for j, q in enumerate(reversed(orders) if inverse else orders):
            stage = _dit_stage_rows if inverse else _dif_stage_rows
            xr, xi = stage(xr, xi, cfg, s0 + j, q, w_re, w_im,
                           _plan(cfg, s0 + j, inverse) if q >= 2 else None)
    return np.asarray(xr), np.asarray(xi)


@pytest.mark.parametrize("stimulus", ["random", "adversarial"])
@pytest.mark.parametrize("mode", list(GROUP_MODES))
@pytest.mark.parametrize("top,stages", GROUPS)
def test_group_reference_equals_jax_stages_composed(top, stages, mode,
                                                    stimulus):
    """A group step's plain version is its stages one after the other, each
    wrapped to its own width: ``_dif_stage_rows`` composed, once and
    twice (the second application three bits wider in unscaled mode)."""
    cfg = _group_cfg(mode)
    step = f"group{stages}_p{top}"
    for k in (1, 2):
        xr, xi = _tile(top, 16, stimulus, seed=top * 8 + stages + k)
        want = _jax_group(cfg, xr, xi, top, stages, k)
        got = _port(step, cfg, xr, xi, k)
        for g, w in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("stimulus", ["random", "adversarial"])
@pytest.mark.parametrize("mode", list(GROUP_MODES))
@pytest.mark.parametrize("top", [7, 5, 4])
def test_two_stage_group_equals_jax_pair_stage(top, mode, stimulus):
    """Two stages of a group against the JAX package's own two-stage body
    ``_dif_pair_stage_rows`` (orders p and p - 1, both >= 3)."""
    cfg = _group_cfg(mode)
    pc = P(cfg)
    xr, xi = _tile(top, 16, stimulus, seed=top)
    want = _jax_group(cfg, xr, xi, top, 2, pair=True)
    got = ps.group_reference(torch.from_numpy(xr).long(),
                             torch.from_numpy(xi).long(), pc, top, 2,
                             pc.data_width, ps.stage_tables(pc, "cpu"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    if top == 7:
        for g, w in zip(_port("group2_p7", cfg, xr, xi, 1), want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("stimulus", ["random", "adversarial"])
@pytest.mark.parametrize("mode", list(GROUP_MODES))
@pytest.mark.parametrize("top,stages", GROUPS)
def test_inverse_group_reference_equals_jax_dit_stages(top, stages, mode,
                                                       stimulus):
    """The inverse group runs its orders from the bottom up, B times the
    conjugate twiddle first: ``_dit_stage_rows`` composed."""
    cfg = _group_cfg(mode)
    pc = P(cfg)
    xr, xi = _tile(top - stages + 1, 16, stimulus, seed=top + 40)
    want = _jax_group(cfg, xr, xi, top, stages, inverse=True)
    got = ps.group_reference(torch.from_numpy(xr).long(),
                             torch.from_numpy(xi).long(), pc, top, stages,
                             pc.data_width, ps.stage_tables(pc, "cpu"),
                             inverse=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("mode", list(GROUP_MODES))
@pytest.mark.parametrize("n", [8, 16, 32, 64, 256])
def test_groups_of_a_factor_equal_jax_transform_rows(n, mode, inverse):
    """A whole factor as the pass runs it: the groups of ``group_split``,
    forward from the top, inverse from the bottom, against
    ``_transform_rows`` in the raw (bit-reversed spectrum) contract, on
    full-scale adversarial columns.  n = 8 ... 64 cover remainders 0, 1
    and 2 of the group size."""
    cfg = _group_cfg(mode, n=n)
    pc = P(cfg)
    xr, xi = _tile(0, 16, "adversarial", seed=n, n=n)
    w_re, w_im = (jnp.asarray(t) for t in _pack_tables(cfg, inverse))
    want = _transform_rows(jnp.asarray(xr), jnp.asarray(xi), cfg, inverse,
                           w_re, w_im, _cmult_plans(cfg, inverse))
    groups = ps.group_split(cfg.stages)
    yr, yi = torch.from_numpy(xr).long(), torch.from_numpy(xi).long()
    done = 0
    for top, stages in (reversed(groups) if inverse else groups):
        yr, yi = ps.group_reference(
            yr, yi, pc, top, stages,
            pc.data_width + done * (1 - pc.scale),
            ps.stage_tables(pc, "cpu"), inverse=inverse)
        done += stages
    assert done == cfg.stages
    np.testing.assert_array_equal(yr.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(yi.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("mode", list(GROUP_MODES))
@pytest.mark.parametrize("step", [s for s in ps.TALL_STEPS
                                  if s.startswith("group")])
def test_tall_tile_group_steps_equal_jax_stages(step, mode):
    """The group steps timed on the tallest tile (``TALL_ROWS`` rows): their
    plain version there against ``_dif_stage_rows`` composed, on full-scale
    adversarial columns."""
    s = ps.STEPS[step]
    cfg = _group_cfg(mode, n=ps.TALL_ROWS)
    xr, xi = _tile(s.order, 16, "adversarial", seed=s.order, n=ps.TALL_ROWS)
    want = _jax_group(cfg, xr, xi, s.order, s.stages)
    for g, w in zip(_port(step, cfg, xr, xi, 1), want):
        np.testing.assert_array_equal(g, w)
    assert set(ps.TALL_STEPS) <= set(ps.STEPS) and ps.TALL_ROWS == 4096


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("log_rows", range(3, 13))
def test_group_split_covers_every_stage_once(log_rows, wide):
    """Every twiddle order log_rows - 1 ... 0 lies in exactly one group,
    from the top down; no group holds more than the tile's group size, and
    only the last holds fewer."""
    groups = ps.group_split(log_rows, wide)
    orders = [q for top, r in groups for q in range(top, top - r, -1)]
    assert orders == list(range(log_rows - 1, -1, -1))
    size = ps.GROUP_SIZE[wide]
    assert all(r == size for _, r in groups[:-1])
    assert 1 <= groups[-1][1] <= size
    from intfftk_tpu_torch.tools import audit_sass
    assert audit_sass.group_split(log_rows, wide) == groups


def test_step_table():
    """The TPU tool's keys where a step means the same, and one kernel
    index per kind."""
    for key in [f"prod_p{p}" for p in (0, 1, 2, 3, 4, 5, 7)] + [
            "arith6", "arith12", "epilogue_cmult"]:
        assert key in ps.STEPS
    assert {f"shfl_p{p}" for p in range(5)} <= set(ps.STEPS)
    assert all(ps.STEPS[f"shfl_p{p}"].variant_of == f"prod_p{p}"
               for p in range(5))
    assert "smem_roundtrip" in ps.STEPS
    assert (ps.PROD, ps.SHFL, ps.ARITH6, ps.ARITH12, ps.SMEM, ps.EPI) == (
        0, 1, 2, 3, 4, 5)
    rnd, uns = ps.probe_config(), ps.check_config()
    assert (rnd.mode, rnd.rounding, rnd.data_width, rnd.twiddle_width,
            rnd.n) == ("scaled", "round", 16, 16, 256)
    assert uns.data_width + ps.MAX_CHECK_K <= 32 and not uns.scale
    assert ps.kernel_index("prodmode_p7", rnd) == ps.PROD_ROUND
    assert ps.kernel_index("prodmode_p7", uns) == ps.PROD_UNSCALED
    assert ps.kernel_index("prod_p7", uns) == ps.PROD
    assert ps.kernel_index("groupmode3_p7", rnd) == ps.GROUP_ROUND3
    assert ps.kernel_index("groupmode2_p1", uns) == ps.GROUP_UNSCALED2
    assert ps.kernel_index("group3_p7", rnd) == ps.GROUP3 == 11
    assert all(ps.STEPS[s].stages == int(re.match(
        r"group(?:64_|mode)?(\d)_p", s).group(1)) for s in ps.STEPS
        if s.startswith("group"))
    assert ps.check_k("group3_p7", uns) == 5 and ps.check_k(
        "group3_p7", rnd) == ps.MAX_CHECK_K == ps.check_k("prod_p7", uns)
    assert ps.K_BASE[0] < ps.K_BASE[1] < ps.K_BASE[2]


def test_wrapper_checks():
    cfg = P(_cfg("unscaled"))
    xr, xi = (torch.from_numpy(v) for v in _tile(0, 16, "random"))
    tabs = ps.stage_tables(cfg, "cpu")
    with pytest.raises(ValueError, match="bad step"):
        ps.stage_loop("roll_p0", xr, xi, 1, cfg, tabs)
    with pytest.raises(ValueError, match="int32"):
        ps.stage_loop("prod_p0", xr.long(), xi.long(), 1, cfg, tabs)
    with pytest.raises(ValueError, match="int64"):
        ps.stage_loop("prod64_p0", xr, xi, 1, cfg, tabs)
    with pytest.raises(ValueError, match="< 0"):
        ps.stage_loop("prod_p0", xr, xi, -1, cfg, tabs)
    with pytest.raises(ValueError, match="outgrow"):
        ps.stage_loop("prod_p0", xr, xi, 17, cfg, tabs)
    with pytest.raises(ValueError, match="rows"):
        ps.stage_loop("prod_p7", xr[:64], xi[:64], 1, P(_cfg("unscaled",
                                                             n=64)), tabs)
    with pytest.raises(ValueError, match="outgrow"):
        ps.stage_loop("group3_p7", xr, xi, 6, cfg, tabs)
    with pytest.raises(ValueError, match="scaled/truncate"):
        ps.stage_loop("prodmode_p0", xr, xi, 1, P(JaxConfig(
            n=N, mode="scaled", rounding="truncate", data_width=16,
            twiddle_width=16)), tabs)


def test_check_reading_guards():
    peak = 132 * 128 * 1.98e9
    ok = ps.StageReading("prod_p7", 6.5e11, 6.55e11, 6.45e11, ps.K_BASE,
                         (10.0, 25.0, 40.0))
    ps.check_reading(ok, peak)
    assert ok.ns_per_sample_per_stage == pytest.approx(1e9 / 6.5e11)
    with pytest.raises(ps.GuardError, match="not linear"):
        ps.check_reading(ok._replace(per_s_lo=8e11), peak)
    folded = ok._replace(per_s=4e12, per_s_lo=4e12, per_s_hi=4e12)
    with pytest.raises(ps.GuardError, match="folded loop"):
        ps.check_reading(folded, peak)
    # the floor is the production steps': a register step may run faster
    ps.check_reading(folded._replace(step="arith6"), peak)


def test_measurements_need_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = ps.probe_config()
    for fn in (ps.measure_all, ps.bit_checks,
               lambda device=None: ps.stage_rate("prod_p7", device=device),
               lambda device=None: ps.stage_input("prod_p7", cfg, device),
               lambda device=None: ps.tile_readings(device=device),
               lambda device=None: ps.stage_input(
                   "prod_p7", cfg, device, geometry="pr6", layout="swizzle")):
        with pytest.raises(RuntimeError):
            fn(device="cpu")
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fn()


# ------------------------------------------------ the tile's bank mapping

from intfftk_tpu_torch.ops.tuning import TUNINGS

H100 = TUNINGS["sm_90"]
#: The steps that keep a tile in shared memory.
TILE_STEPS_ALL = [s for s, v in ps.STEPS.items() if not v.in_registers]


def _tiles(step, n):
    """The TC of each geometry of ``step`` at n rows on the H100's row."""
    return {g: ps.launch_geometry(step, n, g, H100)[0] for g in ps.GEOMETRIES}


def test_launch_geometries():
    """"pass": the factor pass's own resolution on the H100 (TC 8 and 128
    threads at m = 256 on the int32 tile, 16 and 256 on the int64 tile; the
    tallest tile 4 and 2 columns at 512 threads); "pr6": the probe's first
    tile, 256 threads and TC = min(16, 64 KiB / row bytes)."""
    from intfftk_tpu_torch.ops.tuning import pass_geometry
    want = {("prod_p7", 256, "pass"): (8, 128),
            ("group64_3_p7", 256, "pass"): (16, 256),
            ("prod_p7", 4096, "pass"): (4, 512),
            ("group64_3_p7", 4096, "pass"): (2, 512),
            ("prod_p7", 256, "pr6"): (16, 256),
            ("group64_3_p7", 256, "pr6"): (16, 256),
            ("prod_p7", 4096, "pr6"): (4, 256),
            ("group64_3_p7", 4096, "pr6"): (2, 256)}
    for (step, n, g), geo in want.items():
        assert ps.launch_geometry(step, n, g, H100) == geo, (step, n, g)
        assert ps.swizzle_ok(geo[0], ps.STEPS[step].wide)
    for n in (8, 64, 1024):
        for wide in (False, True):
            g = pass_geometry(H100, n, None, wide)
            step = "group64_3_p2" if wide else "group3_p2"
            assert ps.launch_geometry(step, n, "pass", H100) == (
                g["lane_tile"], g["threads"])
    with pytest.raises(ValueError, match="geometry"):
        ps.launch_geometry("prod_p7", 256, "pr7", H100)


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
def test_swizzle_rule(wide):
    """The rule's range (TC from W / 8 to W, W = 128 / word bytes), its
    table (v0 = G - 1, v1 = max(G / 4, 1) mod G, v2 = G / 2 XORed over the
    bits of the line's low three bits) and that it permutes each 128-byte
    line of every tile in range."""
    w = 128 // (8 if wide else 4)
    assert [tc for tc in range(1, 65) if ps.swizzle_ok(tc, wide)] == [
        w // 8, w // 4, w // 2, w]
    for tc in (w // 8, w // 4, w // 2, w):
        g = w // tc
        v = (g - 1, max(g // 4, 1) % g if g > 1 else 0, g // 2)
        table = ps.swizzle_table(tc, wide)
        for line in range(8):
            s = 0
            for b in range(3):
                if line >> b & 1:
                    s ^= v[b]
            assert (table >> (4 * line)) & 15 == s < g
        for rows in (8, 256):
            off = [ps.tile_offset("swizzle", r, c, tc, wide)
                   for r in range(rows) for c in range(tc)]
            assert sorted(off) == list(range(rows * tc))
            assert all(e // w == i // w for i, e in enumerate(off))
    with pytest.raises(ValueError, match="layout"):
        ps.tile_offset("swizzle", 0, 0, w // 16, wide)


@pytest.mark.parametrize("geometry", ps.GEOMETRIES)
@pytest.mark.parametrize("step", TILE_STEPS_ALL)
def test_swizzled_tile_takes_one_wavefront_per_access(step, geometry):
    """Every warp access of every step (the tile's load and store, each
    round-trip or group access, the shuffle step's column, the staged
    twiddles) on the swizzled tile of the tool's shape takes the least
    wavefronts: one, or one per half-warp of the int64 tile."""
    tc = _tiles(step, 256)[geometry]
    excess, accesses, worst = ps.bank_excess(step, 256, tc, "swizzle")
    assert accesses > 0 and excess == 0
    assert worst == (2 if ps.STEPS[step].wide else 1)


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("rows", [8, 16, 32, 64])
def test_swizzled_tile_over_the_rule_range(rows, wide):
    """At every TC of the rule's range on small tiles, where a warp spans
    the most rows, every step's accesses take the least wavefronts."""
    w = 128 // (8 if wide else 4)
    for tc in (w // 8, w // 4, w // 2, w):
        for step in TILE_STEPS_ALL:
            s = ps.STEPS[step]
            if (s.wide != wide or s.order >= rows.bit_length() - 1
                    or (s.index == ps.SHFL and rows < 32)):
                continue
            assert ps.bank_excess(step, rows, tc, "swizzle")[0] == 0, (
                step, rows, tc)


@pytest.mark.parametrize("step", list(ps.TALL_STEPS) + ["group64_3_p7",
                                                          "group64_3_p2"])
def test_swizzled_tall_tile(step):
    """The tallest tile, 4096 rows at the pass's TC (4 on the int32 tile,
    2 on the int64 tile): one wavefront per access (per half-warp)."""
    tc = _tiles(step, ps.TALL_ROWS)["pass"]
    assert ps.bank_excess(step, ps.TALL_ROWS, tc, "swizzle")[0] == 0


@pytest.mark.parametrize("step", ["smem_roundtrip", "prod_p7", "group3_p7",
                                  "epilogue_cmult", "twsmem_p7"])
def test_pass_layout_takes_two_wavefronts(step):
    """The pass's own tile at its geometry (TC 8, rows 9 words apart) and
    the probe's first one (TC 16, 17 words): a warp spans 4 or 2 rows, and
    every access of these steps to the tile takes two wavefronts (the
    staged twiddles of twsmem_p7 take one)."""
    for tc in (8, 16):
        excess, accesses, worst = ps.bank_excess(step, 256, tc, "pass")
        tile = accesses - (256 * tc // 64 if step == "twsmem_p7" else 0)
        assert excess == tile and worst == 2, (step, tc)


def test_pass_layout_is_the_pass_addresses():
    """``layout="pass"`` places (r, c) where ``fused_pass.cuh`` does: a
    group's rows base + (a << lo) at base * ld + c + a * (ld << lo) with
    ld = TC + 1 (run_group, group_load_tile), a turned load's row r at
    r * ld + c; and a task's rows as ``warp_accesses`` lists them."""
    tc, ld = 8, 9
    for lo, r_ in ((5, 3), (2, 3), (0, 2)):
        accesses = ps.warp_accesses(f"group{r_}_p{lo + r_ - 1}", 256, tc)
        tasks = (256 >> r_) * tc
        for u in range(tasks):
            c, t = u & (tc - 1), u >> 3
            k0 = t & ((1 << lo) - 1)
            base = ((t >> lo) << (lo + r_)) | k0
            for a in range(1 << r_):
                row = base + (a << lo)
                assert ps.tile_offset("pass", row, c, tc) == (
                    base * ld + c + a * (ld << lo))
                # the group's accesses follow the tile's load
                acc = accesses[256 * tc // 32 + (u // 32) * (1 << r_) + a]
                assert acc[u % 32] == (row, c)
    assert all(ps.tile_offset("pass", r, c, tc) == r * ld + c
               for r in range(256) for c in range(tc))


def test_warp_accesses_and_wavefronts():
    """The model's counts: a 4-byte access of 32 distinct banks is one
    wavefront, 32 words on one bank 32; an 8-byte access two (a half-warp
    each); the accesses of a step are its load and store and its own."""
    assert ps.wavefronts(list(range(32))) == 1
    assert ps.wavefronts([32 * i for i in range(32)]) == 32
    assert ps.wavefronts([5] * 32) == 1                       # a broadcast
    assert ps.wavefronts(list(range(64)), wide=True) == 2
    assert ps.least_wavefronts(32, True) == 2
    assert ps.least_wavefronts(16, True) == ps.least_wavefronts(32) == 1
    tile = 256 * 8 // 32
    assert len(ps.warp_accesses("smem_roundtrip", 256, 8)) == 2 * tile
    assert len(ps.warp_accesses("group3_p7", 256, 8)) == tile + tile
    assert len(ps.warp_accesses("twsmem_p7", 256, 8)) == tile + tile // 2 * 3
    assert ps.warp_accesses("arith12", 256, 8) == []
    shfl = ps.warp_accesses("shfl_p2", 256, 8)[tile:]
    assert len(shfl) == tile and shfl[0] == [(r, 0) for r in range(32)]


@pytest.mark.parametrize("layout", ps.LAYOUTS)
@pytest.mark.parametrize("geometry", ps.GEOMETRIES)
@pytest.mark.parametrize("step", list(ps.TILE_STEPS))
def test_geometry_and_layout_take_the_plain_version(step, geometry, layout):
    """On the CPU ``stage_loop`` at every geometry and layout is the plain
    version, whose bits depend on neither; the wrapper refuses an unknown
    geometry or layout."""
    cfg = _cfg("unscaled")
    s = ps.STEPS[step]
    xr, xi = _tile(s.order, 16, "adversarial", seed=s.order)
    k = ps.check_k(step, P(cfg))
    got = _port(step, cfg, xr, xi, k, geometry=geometry, layout=layout)
    want = [t.numpy() for t in ps.stage_loop_reference(
        step, torch.from_numpy(xr), torch.from_numpy(xi), k, P(cfg),
        ps.stage_tables(P(cfg), "cpu"))]
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    if s.stages == 3:
        jax_want = _jax_group(_group_cfg("unscaled"), xr, xi, s.order, 3, k)
        assert all(np.array_equal(g, w) for g, w in zip(got, jax_want))
    once = _port(step, cfg, xr, xi, 1, once=True, geometry=geometry,
                 layout=layout)
    assert all(np.array_equal(g, w) for g, w in zip(once, _port(
        step, cfg, xr, xi, 1)))
    for bad in (dict(geometry="pr7"), dict(layout="padded")):
        with pytest.raises(ValueError, match="geometry"):
            _port(step, cfg, xr, xi, 1, **bad)
