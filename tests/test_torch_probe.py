"""The ceiling probes and the roofline model of the port on the CPU: the
plain version of every chain body (intfftk_tpu_torch.tools.probe_vpu)
against a numpy loop with wrap-around and, for the two bodies that set the
integer ceiling and for the int16 add chain (K9), against the TPU tool's
own bodies on jnp arrays; the cost model
(intfftk_tpu_torch.utils.roofline) against the JAX package's for the same
arguments and ceilings; the device resolver."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intfftk_tpu.utils import roofline as jr
from intfftk_tpu_torch.config import FFTConfig
from intfftk_tpu_torch.device import resolve, use_kernel
from intfftk_tpu_torch.ops.fused_fft import LargeFFTPlan
from intfftk_tpu_torch.parallel import Channelizer
from intfftk_tpu_torch.runtime import StreamExecutor
from intfftk_tpu_torch.tools import probe_vpu as pv
from intfftk_tpu_torch.utils import roofline as pr


def _tpu_tool():
    """tools/probe_vpu.py of the JAX package's repo, loaded by path (the
    directory is no package)."""
    path = Path(__file__).resolve().parents[1] / "tools" / "probe_vpu.py"
    spec = importlib.util.spec_from_file_location("tpu_probe_vpu", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np_body(body, c):
    """One iteration of ``body`` on a numpy int32/int16 array, wrapping:
    the source of tools/probe_vpu.py, op for op (``pair``: the port's pipe
    probe, element i on chain (i // 256) % 8 of its thread, the even chains
    doubling the element's two int16 halves, the odd ones squaring it)."""
    if body in ("add", "add_vadd2", "add_unpacked"):
        return c + c
    if body == "add16x":
        for _ in range(16):
            c = c + c
        return c
    if body == "mul":
        return c * c
    if body == "mul16x":
        for _ in range(16):
            c = c * c
        return c
    if body == "shift":
        return (c >> 1) << 1
    if body == "bitwise":
        return (c | 1) & -2
    if body == "mixed7":
        d = (c >> 1) + (c << 1)
        e = c * (c | 1)
        return d + e * c
    if body == "stagemix10":
        d = (c >> 1) + (c << 1)
        e = (c * (c & -2)) >> 2
        f = (d - e) + c * e
        return f + d
    if body == "select":
        return np.where(c > 0, c + 1, c - 1).astype(c.dtype)
    if body == "pair":
        odd = np.arange(c.size) // 256 % 8 % 2 == 1
        h = c.view(np.int16)
        return np.where(odd, c * c, (h + h).view(np.int32))
    return np.roll(c.reshape(-1, 32), 1, axis=1).reshape(c.shape) + c.dtype.type(1)


def _input(dtype, n=4096, seed=0):
    info = np.iinfo(dtype)
    x = np.random.default_rng(seed).integers(info.min, info.max + 1, n,
                                             dtype=dtype)
    x[:4] = (info.min, info.max, 0, -1)          # the wrap-around corners
    return x


@pytest.mark.parametrize("k", [0, 1, 5, 64])
@pytest.mark.parametrize("body", pv.INT32_BODIES)
def test_chain_reference_int32(body, k):
    x = _input(np.int32, seed=k)
    want = x.copy()
    with np.errstate(over="ignore"):
        for _ in range(k):
            want = _np_body(body, want)
    got = pv.chain_reference(body, torch.from_numpy(x), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # on a CPU tensor the wrapper is its plain version and launches nothing
    before = pv.probe_chain.launches
    assert torch.equal(pv.probe_chain(body, torch.from_numpy(x), k), got)
    assert pv.probe_chain.launches == before


@pytest.mark.parametrize("k", [1, 5, 64])
@pytest.mark.parametrize("body, fn", [("mixed7", "_mixed7"),
                                      ("stagemix10", "_stage_mix10")])
def test_chain_reference_equals_tpu_tool_body(body, fn, k):
    """The two bodies that set the integer ceiling are module-level
    functions of the TPU tool: run them ``k`` times on the same seeded
    int32 input as a jnp array on the CPU."""
    x = _input(np.int32, seed=10 + k)
    step = getattr(_tpu_tool(), fn)
    c = jnp.asarray(x)
    for _ in range(k):
        c = step(c)
    assert c.dtype == jnp.int32
    got = pv.chain_reference(body, torch.from_numpy(x), k)
    assert np.array_equal(got.numpy(), np.asarray(c))


K16 = [0, 1, 5, 7, 15, 16, 17, 64, 256]


@pytest.mark.parametrize("k", K16)
@pytest.mark.parametrize("body", pv.INT16_BODIES)
def test_chain_reference_int16(body, k):
    """K9's packed chain and the two readings beside it compute the same
    function: k doublings of every int16 value, wrapping (from k = 16 on,
    every value is 0)."""
    x = _input(np.int16, seed=k)
    want = x.copy()
    with np.errstate(over="ignore"):
        for _ in range(k):
            want = _np_body(body, want)
    before = pv.probe_chain.launches_int16
    got = pv.probe_chain(body, torch.from_numpy(x), k)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    assert pv.probe_chain.launches_int16 == before


@pytest.mark.parametrize("k", K16)
def test_packed_chain_equals_mk16_body(k):
    """K9's packed chain against ``mk16``'s body (tools/probe_vpu.py:219-236)
    on the same seeded int16 input as a jnp array on the CPU: ``c + c`` in a
    ``fori_loop``, without the ``pallas_call``."""
    x = _input(np.int16, seed=20 + k)
    c = jax.lax.fori_loop(0, k, lambda i, c: c + c, jnp.asarray(x))
    assert c.dtype == jnp.int16
    got = pv.probe_chain("add", torch.from_numpy(x), k)
    assert np.array_equal(got.numpy(), np.asarray(c))


def test_int16_chains_table():
    """An int16 tensor's "add" is K9's packed chain, two values a register,
    under the TPU tool's key; the all-VIADD.16x2 chain and the unpacked
    chain are readings of their own."""
    assert pv.INT16_BODIES == ("add", "add_vadd2", "add_unpacked")
    assert [pv.body_of(b, torch.int16).key for b in pv.INT16_BODIES] == [
        "add16_ops_per_s", "add16_vadd2_ops_per_s",
        "add16_unpacked_ops_per_s"]
    assert pv.body_of("add", torch.int32).key == "add_ops_per_s"
    assert [pv.per_register(b, torch.int16) for b in pv.INT16_BODIES] == [
        2, 2, 1]
    assert pv.per_register("add", torch.int32) == 1
    assert [pv.chain_of(n) for n in pv.CHAIN_ORDER] == [
        (n, torch.int32) if n in pv.BODIES else (
            pv.INT16_NAMES[n], torch.int16) for n in pv.CHAIN_ORDER]
    assert [pv.chain_of(n) for n in ("add16", "add16x")] == [
        ("add", torch.int16), ("add16x", torch.int32)]


def test_copy_reference_and_wrapper_checks():
    x = torch.from_numpy(_input(np.int32))
    assert torch.equal(pv.probe_copy(x), x + 1)
    assert torch.equal(pv.copy_reference(x), x + 1)
    assert pv.probe_copy.launches == 0
    with pytest.raises(TypeError):
        pv.probe_copy(x.long())
    with pytest.raises(ValueError, match="bad body"):
        pv.probe_chain("fma", x, 1)
    with pytest.raises(TypeError, match="int32"):
        pv.probe_chain("mul", x.short(), 1)
    with pytest.raises(TypeError, match="int16"):
        pv.probe_chain("add_unpacked", x, 1)
    with pytest.raises(TypeError, match="int32"):
        pv.probe_chain("pair", x.short(), 1)
    with pytest.raises(ValueError, match="< 0"):
        pv.probe_chain("add", x, -1)
    with pytest.raises(ValueError, match="32"):
        pv.probe_chain("roll", x[:33], 1)


def test_bodies_table():
    """The source-level op counts and keys of tools/probe_vpu.py."""
    ops = {b: pv.BODIES[b].ops for b in pv.INT32_BODIES}
    assert ops == dict(add=1, add16x=16, mul=1, mul16x=16, shift=2,
                       bitwise=2, mixed7=7, stagemix10=10, select=3, roll=2,
                       pair=1)
    keys = [pv.BODIES[b].key for b in pv.INT32_BODIES]
    assert keys == ["add_ops_per_s", "add_unroll16_ops_per_s",
                    "mul_ops_per_s", "mul_unroll16_ops_per_s",
                    "shift_ops_per_s", "bitwise_ops_per_s",
                    "mixed7_ops_per_s", "stagemix10_ops_per_s",
                    "select_ops_per_s", "roll_ops_per_s",
                    "pair_vadd2_imad_instr_per_s"]
    # csrc/probe.cu's kernel indices: the int32 bodies 0-9 and 11, the
    # packed chains 10 and 12 (K9); the unpacked int16 chain is body 0 on
    # uint16_t
    chains = [*pv.BODIES.values(), *pv.INT16_CHAINS.values()]
    assert sorted(b.index for b in chains) == [0, *range(13)]
    assert all(1 <= b.min_instr <= b.ops for b in chains)


def test_check_reading_guards():
    peak = 132 * 128 * 1.98e9
    ok = pv.ChainReading("mixed7", torch.int32, 5e13, 5.05e13, 4.95e13,
                         pv.K_BASE, (1.0, 2.0, 3.0))
    pv.check_reading(ok, peak)
    bent = ok._replace(ops_per_s_lo=6e13)
    with pytest.raises(pv.GuardError, match="not linear"):
        pv.check_reading(bent, peak)
    folded = pv.ChainReading("add", torch.int32, 4e14, 4e14, 4e14,
                             pv.K_BASE, (1.0, 1.1, 1.2))
    with pytest.raises(pv.GuardError, match="folded chain"):
        pv.check_reading(folded, peak)
    # the packed int16 add counts two ops per lane-instruction: 40 T ops/s
    # is within its limit and above the unpacked chain's
    packed = pv.ChainReading("add", torch.int16, 4e13, 4e13, 4e13,
                             pv.K_BASE, (1.0, 2.0, 3.0))
    pv.check_reading(packed, peak)
    with pytest.raises(pv.GuardError, match="folded chain"):
        pv.check_reading(packed._replace(body="add_unpacked"), peak)


def test_ceilings_from_a_measured_dict():
    """The ops ceiling is the better mixed chain; the bytes ceiling is the
    card's memory peak, never the copy kernel's own reading."""
    d = {"mixed7_ops_per_s": 5.2e13, "stagemix10_ops_per_s": 4.3e13,
         "hbm_bytes_per_s": 2.78e12, "hbm_peak_bytes_per_s": 3.35e12,
         "add_unroll16_ops_per_s": None}
    assert pv.ceilings_from(d) == (5.2e13, 3.35e12)
    d["stagemix10_ops_per_s"] = 6e13
    assert pv.ceilings_from(d) == (6e13, 3.35e12)
    assert pv.BODIES["add16x"].key in pv.FOLDED_KEYS
    assert set(pv.CHAIN_ORDER) == set(pv.INT32_BODIES) | set(pv.INT16_NAMES)


def test_measurements_need_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    for fn in (pv.same_session_ceilings, pv.measure_all, pv.probe_hbm,
               pv.chain_input, pv.lane_rate_peak, pv.memory_peak,
               lambda device=None: pv.bend(1, device=device)):
        with pytest.raises(RuntimeError):
            fn(device="cpu")
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fn()


CEILINGS = [(52.3e12, 2.78e12), (1e12, 3e12), (1e15, 1e11)]


@pytest.mark.parametrize("ceil", CEILINGS, ids=["measured", "ops", "bytes"])
def test_roofline_equals_jax(ceil):
    assert pr.OPS_PER_SAMPLE_STAGE == jr.OPS_PER_SAMPLE_STAGE
    pairs = [(pr.fft_cost(4096, 4096), jr.fft_cost(4096, 4096)),
             (pr.fft_cost(1024, 3, fused=False), jr.fft_cost(1024, 3, False)),
             (pr.fft_cost(64, 5, ops_per_sample_stage=7.0),
              jr.fft_cost(64, 5, ops_per_sample_stage=7.0))]
    for itemsize in (2, 4, 8):
        for crossings in (2, 4):
            kw = dict(itemsize=itemsize, crossings=crossings)
            pairs.append((pr.large_fft_cost(1 << 16, 64, **kw),
                          jr.large_fft_cost(1 << 16, 64, **kw)))
    for p, j in pairs:
        assert (p.int_ops, p.hbm_bytes) == (j.int_ops, j.hbm_bytes)
        assert p.time_bound(ceil) == j.time_bound(ceil)
        assert pr.roofline_fraction(1e-3, p, ceil) == jr.roofline_fraction(
            1e-3, j, ceil)
    c = pr.KernelCost(int_ops=2e9, hbm_bytes=1e8)
    assert c.time_bound(ceil) == max(2e9 / ceil[0], 1e8 / ceil[1])
    assert not hasattr(pr, "TPU_SPECS")


def test_resolver():
    assert resolve("cpu") == torch.device("cpu")
    assert resolve(torch.device("cpu")) == torch.device("cpu")
    assert use_kernel(resolve("cpu")) is False
    with pytest.raises(RuntimeError, match="no compute path"):
        resolve("meta")
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve(None)


@pytest.mark.parametrize("build", [
    lambda: LargeFFTPlan(FFTConfig(n=4096)),
    lambda: Channelizer(FFTConfig(n=64)),
    lambda: StreamExecutor(lambda a, b: (a, b), n=64)],
    ids=["LargeFFTPlan", "Channelizer", "StreamExecutor"])
def test_entry_points_need_the_card_or_cpu(build):
    """With no device argument an entry point builds on the card; where
    there is none it raises and names device="cpu": it never falls back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build()
