"""The per-stage probe of the port on the CPU: the plain version of every
step (intfftk_tpu_torch.tools.probe_stages.stage_loop_reference) against
the JAX package's own stage function ``_dif_stage_rows`` on jnp arrays (the
same numpy-seeded tile through both, exactly), against the TPU tool's
production step (``tools/probe_stages.py:make_prod_step``) and its op
images; the step table, the guards and the refusals.  Tolerance 0
throughout."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intfftk_tpu.config import FFTConfig as JaxConfig
from intfftk_tpu.ops import intmath as jm
from intfftk_tpu.ops.pallas_fft import _dif_stage_rows, _pack_tables
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
    for k in (1, ps.MAX_CHECK_K):
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
    narrow = step.replace("64", "")
    got = ps.stage_loop(step, xr.long(), xi.long(), 3, cfg, tabs, epi)
    want = ps.stage_loop(narrow, xr, xi, 3, cfg, tabs, epi)
    assert got[0].dtype == torch.int64
    assert all(torch.equal(g, w.long()) for g, w in zip(got, want))


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
               lambda device=None: ps.stage_input("prod_p7", cfg, device)):
        with pytest.raises(RuntimeError):
            fn(device="cpu")
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fn()
