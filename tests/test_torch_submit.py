"""The submission layer of the port (prepared passes, one C call per plan
call, captured calls) on the CPU, where no card and no kernel library
exist: the library is replaced by a stub that records what each C entry
is handed, and the launch path is forced on CPU tensors.

The prepared chain of every ``LargeFFTPlan`` form, of the single-pass
plans and of the convolution must hand the C entries the same integers
and table pointers, pass by pass, that the per-pass ``fused_pass`` path
hands ``intfft_fused_pass``, with each pass reading the one before it;
the chain is prepared once per (shape, dtype, device), again after
``retune``; ``captured`` refuses CPU tensors.  Bits on the card:
tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

from intfftk_tpu_torch.config import FFTConfig
from intfftk_tpu_torch.golden import make_conv_spec
from intfftk_tpu_torch.ops import _build
from intfftk_tpu_torch.ops import fused_fft, intmath, pair, single_pass
from intfftk_tpu_torch.ops.fused_fft import (LargeFFTPlan, PreparedChain,
                                              fused_pass, products_note)
from intfftk_tpu_torch.ops.intmath import PreparedProduct, spectrum_product
from intfftk_tpu_torch.ops.single_pass import (FusedAxisFFT, PallasFFTPlan,
                                               PallasWideFFTPlan)
from intfftk_tpu_torch.ops.tuning import TUNINGS, tile_skew
from intfftk_tpu_torch.parallel import OverlapSaveConv
from intfftk_tpu_torch.parallel import convolve
from intfftk_tpu_torch.runtime import CapturedCall, captured, trace

#: Which table pointers a pass takes, as the C entries' mask: w, t2, e, c.
MASK_BITS = (1, 2, 4, 8)
#: The integers of a pass the C entries take (``fused_fft._pass_ints``):
#: the product form at 20, the edge's kind, blocks, payload and lead at
#: 21-24.
N_INTS = 25


class StubLibrary:
    """Stands in for the kernel library: records every pass each C entry
    would launch as (its integers, its 12 pointers) and launches nothing.
    ``fail`` makes the next chain call return that CUDA error."""

    def __init__(self):
        self.launched = []          # (entry, ints, ptrs) per pass
        self.prepared = []          # (ints, mask, device) per prepare
        self.chain_calls = 0
        self.pass_calls = 0
        self.fail = 0

    def intfft_prepared_size(self):
        return 64

    def intfft_error_string(self, err):
        return b"stub error"

    def intfft_fused_pass(self, *a):
        # x, y, then the tables: recorded in the chain's order (x, tables,
        # y)
        ptrs = (*a[:2], *a[4:12], *a[2:4])
        ints, out = tuple(a[12:12 + N_INTS]), a[14 + N_INTS]
        self.pass_calls += 1
        self.launched.append(("pass", ints, ptrs))
        out[0] = 1
        out[1], out[2] = ints[18], ints[19]
        return 0

    def intfft_prepare_pass(self, *a):
        ints = tuple(a[:N_INTS])
        mask, device, desc, report = a[N_INTS:N_INTS + 4]
        self.prepared.append((ints, mask, device))
        desc[0] = len(self.prepared)            # the descriptor's identity
        report[0], report[1] = ints[18], ints[19]
        # the skew the C entry takes: a forward pass with 1-D stage tables
        # whose store is turned and in natural order (pass_skew)
        turned = not ints[10] and ints[11] and ints[13] and not mask & 2
        report[4] = tile_skew(ints[1], ints[4] if ints[4] == 8 else 4) \
            if turned else 0
        return 0

    def intfft_fused_chain(self, descs, n, ptrs, device, stream, out):
        self.chain_calls += 1
        out[0] = 0
        if self.fail:
            err, self.fail = self.fail, 0
            return err
        words = len(descs) // n
        for k in range(n):
            ints, mask, dev = self.prepared[descs[k * words] - 1]
            p = tuple(ptrs[12 * k:12 * k + 12])
            assert dev == device
            assert mask == sum(bit for bit, i in zip(MASK_BITS, (2, 4, 6, 8))
                               if p[i] is not None)
            self.launched.append(("chain", ints, p))
            out[0] += 1
        return 0

    def intfft_query_whole(self, *a):
        a[-1][3] = 2                            # clusters held at once
        return 0

    def intfft_prepare_whole(self, *a):
        return 0

    def intfft_spectrum_product(self, *a):
        self.launched.append(("product", tuple(a[6:14]), tuple(a[:6])))
        return 0


@pytest.fixture
def lib(monkeypatch):
    """The stub library, with the launch path taken on CPU tensors."""
    stub = StubLibrary()
    monkeypatch.setattr(_build, "library", lambda threads=None: stub)
    for mod in (fused_fft, single_pass, intmath, pair, convolve):
        monkeypatch.setattr(mod, "use_kernel", lambda device: True)
    for mod in (fused_fft, intmath):
        monkeypatch.setattr(mod, "stream_handle", lambda device: 0)
    monkeypatch.setattr(fused_pass, "launches", 0)
    monkeypatch.setattr(spectrum_product, "launches", 0)
    return stub


def _cfg(**kw):
    base = dict(n=4096, mode="scaled", rounding="round", data_width=16,
                twiddle_width=16)
    return FFTConfig(**{**base, **kw})


#: Every LargeFFTPlan form: (config, plan keyword arguments).
PLAN_FORMS = {
    "fourstep-fwd-natural-host": (_cfg(), dict(epi_synth="host")),
    "fourstep-fwd-natural-device": (_cfg(), dict(epi_synth="device")),
    "fourstep-fwd-natural-inkernel": (_cfg(), dict(epi_synth="inkernel")),
    "fourstep-inv-natural-device": (_cfg(), dict(inverse=True)),
    "fourstep-inv-natural-inkernel": (_cfg(), dict(inverse=True,
                                                   epi_synth="inkernel")),
    "fourstep-fwd-raw": (_cfg(), dict(order="raw")),
    "fourstep-inv-raw": (_cfg(), dict(inverse=True, order="raw")),
    "fourstep-unscaled-int32": (_cfg(mode="unscaled", rounding="truncate"),
                                dict(n1=16, n2=256)),
    "monolithic-fwd": (_cfg(), dict(schedule="monolithic")),
    "monolithic-inv": (_cfg(), dict(schedule="monolithic", inverse=True)),
    "monolithic-raw": (_cfg(), dict(schedule="monolithic", order="raw")),
    "wide-int32-to-int64": (_cfg(mode="unscaled", rounding="truncate",
                                 data_width=32, twiddle_width=20),
                            dict(order="raw")),
    "wide-int64-blocks": (_cfg(data_width=44, twiddle_width=20),
                          dict(inverse=True, order="raw")),
}


def _plan(name):
    cfg, kw = PLAN_FORMS[name]
    kw = dict(kw)
    n1, n2 = kw.pop("n1", None), kw.pop("n2", None)
    return LargeFFTPlan(cfg, n1, n2, device="cpu", **kw)


def _blocks(plan, batch, seed=0):
    rng = np.random.default_rng(seed)
    shape = (batch,) + plan.block_in_shape
    return [torch.as_tensor(rng.integers(-100, 100, shape)).to(plan.in_dtype)
            for _ in range(2)]


def _same_launches(per_pass, chained, x):
    """The chain's passes equal the per-pass path's: the same integers and
    table pointers, both reading ``x`` first, each later pass reading the
    output of the pass before it."""
    assert len(per_pass) == len(chained) >= 1
    for path in (per_pass, chained):
        assert path[0][2][:2] == (x[0].data_ptr(), x[1].data_ptr())
        for a, b in zip(path, path[1:]):
            assert b[2][:2] == a[2][10:]
    for (_, ints_a, ptrs_a), (_, ints_b, ptrs_b) in zip(per_pass, chained):
        assert ints_a == ints_b
        assert ptrs_a[2:10] == ptrs_b[2:10]


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("form", list(PLAN_FORMS))
def test_chain_arguments_equal_per_pass(lib, form, batch):
    """apply_blocks through the prepared chain hands the C entries, pass by
    pass, what the per-pass fused_pass path hands intfft_fused_pass: one C
    call for both passes, two launches counted, outputs of the same shape
    and dtype."""
    plan = _plan(form)
    x = _blocks(plan, batch)
    want = plan.apply_blocks(*x, pass_fn=fused_pass)
    per_pass = list(lib.launched)
    assert lib.pass_calls == 2 and fused_pass.launches == 2
    lib.launched.clear()
    got = plan.apply_blocks(*x)
    assert lib.chain_calls == 1 and fused_pass.launches == 4
    _same_launches(per_pass, lib.launched, x)
    assert isinstance(got, tuple) and len(got) == 2
    for a, b in zip(got, want):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
        assert a.shape == (batch,) + plan.block_out_shape
        assert a.dtype == plan.out_dtype and a.is_contiguous()
    assert fused_pass.geometry[:2] == (plan.pass_geometry[1]["lane_tile"],
                                       plan.pass_geometry[1]["threads"])


#: The single-pass plans: (factory, whether the pass is turned, the
#: input's shape from n).
SINGLE_FORMS = {
    "pallas-nb-fwd": (lambda: PallasFFTPlan(_cfg(n=256), device="cpu"),
                      False, lambda n: (n, 5)),
    "pallas-nb-inv-bitrev": (lambda: PallasFFTPlan(
        _cfg(n=256), inverse=True, order="bitrev", device="cpu"), False,
        lambda n: (n, 5)),
    "pallas-bn-fwd": (lambda: PallasFFTPlan(_cfg(n=256), layout="bn",
                                            device="cpu"),
                      True, lambda n: (5, n)),
    "fused-axis-inv": (lambda: FusedAxisFFT(_cfg(n=64), inverse=True,
                                            device="cpu"),
                       True, lambda n: (2, 3, n)),
    "wide-nb": (lambda: PallasWideFFTPlan(
        _cfg(n=256, mode="unscaled", rounding="truncate", data_width=32),
        device="cpu"), False, lambda n: (n, 5)),
}


@pytest.mark.parametrize("form", list(SINGLE_FORMS))
def test_single_pass_chain_arguments(lib, form):
    """A single-pass plan's call is one C call of its prepared pass, with
    the integers and tables fused_pass hands the C entry for the same
    view; a second call prepares nothing."""
    make, turned, shape = SINGLE_FORMS[form]
    plan = make()
    n = plan.cfg.n
    x = [torch.ones(shape(n), dtype=torch.int32) for _ in range(2)]
    y = plan(*x)
    assert lib.chain_calls == 1 and len(lib.prepared) == 1
    assert fused_pass.launches == 1 and y[0].shape == x[0].shape
    _, ints, ptrs = lib.launched[0]
    dt = torch.int64 if plan.wide else torch.int32
    view = [v.to(dt).reshape((1, -1, n) if turned else (1, n, -1))
            for v in x]
    lib.launched.clear()
    fused_pass(*view, plan.cfg, (plan.w_re, plan.w_im), inverse=plan.inverse,
               natural=plan.order == "natural", transpose_in=turned,
               transpose_out=turned, **plan.geometry)
    assert lib.launched[0][1] == ints
    assert lib.launched[0][2][2:10] == ptrs[2:10]
    plan(*x)
    assert lib.chain_calls == 2 and len(lib.prepared) == 1


def test_prepared_once_per_shape_and_dtype(lib):
    """The chain is prepared at the first call with a (batch, dtype,
    device) and reused after; a new batch or dtype prepares again, the old
    key stays."""
    plan = _plan("fourstep-fwd-natural-host")
    x1, x3 = _blocks(plan, 1), _blocks(plan, 3)
    for _ in range(3):
        plan.apply_blocks(*x1)
    assert len(lib.prepared) == 2 and lib.chain_calls == 3
    plan.apply_blocks(*x3)
    assert len(lib.prepared) == 4 and [p[0][0] for p in lib.prepared] == [
        1, 1, 3, 3]
    plan.apply_blocks(*x1)
    assert len(lib.prepared) == 4
    wide = FusedAxisFFT(_cfg(n=64), device="cpu")
    wide(torch.ones((2, 64), dtype=torch.int32),
         torch.ones((2, 64), dtype=torch.int32))
    wide(torch.ones((2, 64), dtype=torch.int16),
         torch.ones((2, 64), dtype=torch.int16))
    assert len(lib.prepared) == 5          # int16 is cast to the same view


def test_new_dtype_prepares_again(lib):
    """Blocks of another dtype are another key: the chain prepared for
    int16 refuses int32 blocks of its shape, and the plan prepares for
    them (the int32 blocks reach the C entry as 4-byte elements)."""
    plan = _plan("fourstep-fwd-natural-host")
    x16 = _blocks(plan, 2)
    chain = PreparedChain(x16[0].shape, x16[0].dtype, x16[0].device,
                          plan.passes())
    x32 = [v.int() for v in x16]
    with pytest.raises(ValueError, match="prepared for"):
        chain(*x32)
    with pytest.raises(ValueError, match="prepared for"):
        chain(*_blocks(plan, 3))
    with pytest.raises(ValueError, match="contiguous"):
        chain(x16[0].transpose(1, 2).contiguous().transpose(1, 2), x16[1])
    before = len(lib.prepared)
    with pytest.raises(TypeError):         # int32 -> int16 is no pass
        plan.apply_blocks(*x32)
    assert len(lib.prepared) == before


def test_retune_invalidates(lib):
    """retune drops the prepared chains (and resets the captured calls made
    from the plan): the next call prepares with the new geometry."""
    plan = _plan("fourstep-fwd-natural-host")
    x = _blocks(plan, 2)
    call = plan.capture()
    call._graphs["marker"] = object()
    plan.apply_blocks(*x)
    assert len(lib.prepared) == 2
    plan.apply_blocks(*x)
    assert len(lib.prepared) == 2
    plan.retune(TUNINGS["default"])
    assert not call._graphs
    plan.apply_blocks(*x)
    assert len(lib.prepared) == 4
    assert lib.prepared[-1][0][18:20] == (plan.pass_geometry[1]["lane_tile"],
                                       plan.pass_geometry[1]["threads"])
    single = PallasFFTPlan(_cfg(n=256), device="cpu")
    scall = single.capture()
    scall._graphs["marker"] = object()
    single.retune(TUNINGS["default"])
    assert not scall._graphs and not single._prepared


def test_to_invalidates(lib):
    """.to() replaces the buffers a chain reads by address: it drops the
    chains and the captured graphs."""
    plan = _plan("fourstep-fwd-natural-host")
    plan.apply_blocks(*_blocks(plan, 1))
    call = plan.capture()
    call._graphs["marker"] = object()
    assert plan._prepared
    plan.to("cpu")
    assert not plan._prepared and not call._graphs


def test_track_reaches_nested_plans():
    """A call tracked on a convolution is reset by a retune of a plan
    inside its pair, and by a .to() of the pair alone."""
    class Call:
        resets = 0

        def reset(self):
            self.resets += 1

    spec = make_conv_spec(n=4096, taps_len=129, factors=(64, 64))
    conv = OverlapSaveConv(spec, np.ones(129, np.int64),
                           np.zeros(129, np.int64), device="cpu")
    call = conv._track(Call())
    conv.pair.inv.retune(TUNINGS["default"])
    assert call.resets == 1
    conv.pair.to("cpu")             # the pair and both of its plans
    assert call.resets > 1


def test_chain_error_raises(lib):
    """A launch error from the C entry raises; the launches made before it
    are counted, none of the failed one."""
    plan = _plan("fourstep-fwd-raw")
    x = _blocks(plan, 1)
    plan.apply_blocks(*x)
    lib.fail = 1
    with pytest.raises(RuntimeError, match="chain launch failed"):
        plan.apply_blocks(*x)
    assert fused_pass.launches == 2


def test_conv_prepared_product(lib):
    """The convolution's product goes out as one PreparedProduct per
    shape, with spectrum_product's arguments, and its transforms as the two
    plans' chains: 4 pass launches and 1 product launch per call, three C
    calls."""
    spec = make_conv_spec(n=4096, taps_len=129, factors=(64, 64))
    rng = np.random.default_rng(3)
    conv = OverlapSaveConv(spec, rng.integers(-99, 99, 129),
                           np.zeros(129, np.int64), device="cpu")
    x = [torch.as_tensor(rng.integers(-99, 99, 2 * spec.payload),
                         dtype=torch.int32) for _ in range(2)]
    for k in (1, 2):
        conv(*x)
        assert (fused_pass.launches, spectrum_product.launches) == (4 * k, k)
        assert lib.chain_calls == 2 * k
    products = [c for c in lib.launched if c[0] == "product"]
    assert len(products) == 2 and products[0][1] == products[1][1]
    assert sum(isinstance(v, PreparedProduct)
               for v in conv.pair._prepared.values()) == 1
    fr = torch.zeros((2,) + conv.pair.fwd.block_out_shape, dtype=torch.int32)
    spectrum_product(fr, fr, conv.pair.hr, conv.pair.hi, spec.product_shift,
                     spec.product_width, spec.spectrum_width, conv.out_dtype)
    assert lib.launched[-1][1] == products[0][1]
    assert lib.launched[-1][2][2:4] == products[0][2][2:4]


@pytest.mark.parametrize("product_width,inverse_form", [
    (44, "mod64"), (52, "limb64")], ids=["44-mod64", "52-int128"])
def test_conv_product_forms_reach_the_c_entries(lib, product_width,
                                                inverse_form):
    """A wide convolution's chains hand intfft_prepare_pass each pass's
    product form as its last integer (1: modulo 2^64), as fused_pass hands
    it to intfft_fused_pass, and each chain's plan.prepare span notes the
    forms: the forward's two passes on the int32 tile, the inverse's two
    on the int64 tile, modular at a 44-bit product, exact (in limbs) at
    52; the product's span notes its sums in long long (int32 data).  No
    pass runs on the skewed tile: the chain's spectrum is in raw order,
    so no store reads bit-reversed rows."""
    spec = make_conv_spec(n=4096, taps_len=129, factors=(64, 64),
                          twiddle_width=16, max_spectrum_width=25,
                          max_product_width=product_width)
    rng = np.random.default_rng(5)
    conv = OverlapSaveConv(spec, rng.integers(-99, 99, 129),
                           np.zeros(129, np.int64), device="cpu")
    x = [torch.as_tensor(rng.integers(-99, 99, 2 * spec.payload),
                         dtype=torch.int32) for _ in range(2)]
    with trace.recording() as rec:
        conv(*x)
    flag = int(inverse_form == "mod64")
    assert [ints[20] for ints, _, _ in lib.prepared] == [0, 0, flag, flag]
    notes = [s.note for s in rec.spans if s.name == "plan.prepare"]
    assert notes == [
        "product int32 2 mod32 0 mod64 0 limb64 0 int128 0 skew 0 "
        "epi host 32768",
        "p1 long long",
        products_note((inverse_form,) * 2, 0, "epi host 32768")]
    chains = [v for v in conv.pair.inv._prepared.values()]
    assert len(chains) == 1 and chains[0].products == (inverse_form,) * 2
    assert [p.product for p in chains[0].passes] == [inverse_form] * 2
    lib.launched.clear()
    yr, _ = conv.pair.inv.apply_blocks(
        *(torch.zeros((2,) + conv.pair.inv.block_in_shape, dtype=torch.int64)
          for _ in range(2)), pass_fn=fused_pass)
    assert [ints[20] for _, ints, _ in lib.launched] == [flag, flag]


def test_conv_edges_reach_the_c_entries(lib):
    """The convolution's chains with the edges hand intfft_prepare_pass,
    as fused_pass hands intfft_fused_pass, the edge of each pass as its
    last four integers: the forward's pass 1 the window (1, payloads per
    row, payload, lead), the inverse's pass 2 the cut (2, ...), the other
    two none; the batch is every row's payloads.  The forward's first
    pass reads the caller's signal and the inverse's last writes the
    call's output, [rows, T] int64.  The pair alone hands no edge."""
    spec = make_conv_spec(n=4096, taps_len=129, factors=(64, 64),
                          twiddle_width=16, max_spectrum_width=25,
                          max_product_width=44)
    rng = np.random.default_rng(7)
    conv = OverlapSaveConv(spec, rng.integers(-99, 99, 129),
                           np.zeros(129, np.int64), device="cpu")
    assert conv.edges == ("window", "cut")
    t = 3 * spec.payload
    x = [torch.as_tensor(rng.integers(-99, 99, (2, t)), dtype=torch.int32)
         for _ in range(2)]
    yr, yi = conv(*x)
    assert yr.shape == (2, t) and yr.dtype == torch.int64
    edge = (3, spec.payload, spec.taps_len - 1)
    none = (0, 0, 0, 0)
    assert [ints[21:] for ints, _, _ in lib.prepared] == [
        (1, *edge), none, none, (2, *edge)]
    assert [ints[0] for ints, _, _ in lib.prepared] == [6] * 4
    chained = [c for c in lib.launched if c[0] == "chain"]
    assert chained[0][2][:2] == (x[0].data_ptr(), x[1].data_ptr())
    assert chained[-1][2][10:] == (yr.data_ptr(), yi.data_ptr())
    lib.launched.clear()
    conv(*x, pass_fn=fused_pass)
    assert [ints for entry, ints, _ in lib.launched if entry == "pass"] == [
        ints for ints, _, _ in lib.prepared]
    lib.prepared.clear()
    blocks = [torch.zeros((2,) + conv.pair.fwd.block_in_shape,
                          dtype=torch.int32) for _ in range(2)]
    conv.pair.apply_blocks(*blocks)
    assert [ints[21:] for ints, _, _ in lib.prepared] == [none] * 4


@pytest.mark.parametrize("cfg,kw,form,skewed", [
    (_cfg(n=1 << 16), {}, "mod32", 1),
    (_cfg(n=1 << 16), dict(inverse=True), "mod32", 0),
    (_cfg(mode="unscaled", rounding="truncate"), dict(n1=16, n2=256),
     "int32", 0)], ids=["core-fwd", "core-inv", "unscaled-4096"])
def test_int32_product_forms_reach_the_c_entries(lib, cfg, kw, form, skewed):
    """The core's 64k chain (scaled 16-bit, 16-bit twiddles: 31 bits kept)
    hands intfft_prepare_pass, and fused_pass hands intfft_fused_pass, the
    modular flag for both passes, and its plan.prepare span notes "mod32
    2"; an unscaled 4096-point chain (its first factor's epilogue at 20
    bits, 35 with the shift) takes the exact form.  The note's "skew"
    counts the forward's first pass, whose turned natural store runs on
    the skewed tile at 256 rows, not at 16."""
    n1, n2 = kw.pop("n1", None), kw.pop("n2", None)
    plan = LargeFFTPlan(cfg, n1, n2, device="cpu", **kw)
    x = _blocks(plan, 2)
    with trace.recording() as rec:
        plan.apply_blocks(*x)
    flag = int(form == "mod32")
    assert [ints[20] for ints, _, _ in lib.prepared] == [flag, flag]
    notes = [s.note for s in rec.spans if s.name == "plan.prepare"]
    assert notes == [products_note((form,) * 2, skewed, plan.epi_note)]
    assert notes[0] == (
        "product int32 0 mod32 2 mod64 0 limb64 0 int128 0" if flag
        else "product int32 2 mod32 0 mod64 0 limb64 0 int128 0") + (
        f" skew {skewed} epi device {8 * plan.n1 * plan.n2}")
    lib.launched.clear()
    plan.apply_blocks(*x, pass_fn=fused_pass)
    assert [ints[20] for _, ints, _ in lib.launched] == [flag, flag]


@pytest.mark.parametrize("cfg,kw,want", [
    (_cfg(), {}, ("int32", "int32")),
    (_cfg(mode="unscaled", rounding="truncate", data_width=32,
          twiddle_width=20), dict(order="raw"), ("int128", "int128"))],
    ids=["narrow", "wide"])
def test_whole_chain_products(lib, cfg, kw, want):
    """A whole-form chain (one cluster launch for both factors) reports
    both factors' product forms: the cluster kernel forms them exactly, in
    64 bits on the int32 tile and in __int128 on the int64 tile, whatever
    the widths."""
    plan = LargeFFTPlan(cfg, device="cpu", fuse="whole", **kw)
    x = _blocks(plan, 2)
    chain = PreparedChain(x[0].shape, x[0].dtype, x[0].device,
                          plan.passes(), whole=plan.whole_geometry)
    assert chain.products == want


def test_prepared_product_checks(lib):
    """A prepared product takes data of its shape, dtype and device only,
    and gives fresh int64 outputs of that shape."""
    h = torch.ones(8, dtype=torch.int32)
    f = torch.ones((3, 8), dtype=torch.int32)
    prod = PreparedProduct(f, f, h, h, 14, 44, 25)
    assert prod.out_dtype == torch.int64
    yr, yi = prod(f, f)
    assert yr.shape == yi.shape == (3, 8) and yi.dtype == torch.int64
    for bad in (torch.ones((2, 8), dtype=torch.int32),
                torch.ones((3, 8), dtype=torch.int64),
                torch.ones((8, 3), dtype=torch.int32).t()):
        with pytest.raises(ValueError, match="prepared for"):
            prod(bad, bad)
    assert spectrum_product.launches == 1


#: Every module with capture(), built on the CPU.
CAPTURABLE = {
    "LargeFFTPlan": lambda: LargeFFTPlan(_cfg(), device="cpu"),
    "PallasFFTPlan": lambda: PallasFFTPlan(_cfg(n=256), device="cpu"),
    "FusedAxisFFT": lambda: FusedAxisFFT(_cfg(n=256), device="cpu"),
    "OverlapSaveConv": lambda: OverlapSaveConv(
        make_conv_spec(n=4096, taps_len=129, factors=(64, 64)),
        np.ones(129, np.int64), np.zeros(129, np.int64), device="cpu"),
}


@pytest.mark.parametrize("name", list(CAPTURABLE))
def test_capture_on_cpu_raises(name):
    """Every plan's capture() is a CapturedCall, and a captured call on a
    CPU tensor raises (there is no graph on the CPU and no fallback); an
    array is refused too, since its copy to the card cannot be replayed."""
    call = CAPTURABLE[name]().capture()
    assert isinstance(call, CapturedCall)
    x = torch.zeros((2, 4096), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        call(x, x)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        call(np.zeros(4), np.zeros(4))
    assert not call._graphs


def test_captured_needs_arguments():
    call = captured(lambda: None)
    with pytest.raises(ValueError, match="positional"):
        call()


def test_chain_runs_in_library_runs(lib, monkeypatch):
    """Passes whose thread counts live in two libraries (a sweep's variant
    beside the library) go out as one C call per run of passes in one
    library, in order, each still reading the pass before it."""
    other = StubLibrary()
    other.prepared = lib.prepared            # one numbering of descriptors
    other.launched = lib.launched
    monkeypatch.setattr(_build, "library",
                        lambda threads=None: other if threads == 1024
                        else lib)
    plan = _plan("fourstep-fwd-natural-host")
    g1, g2 = plan.pass_geometry
    plan.pass_geometry = (g1, dict(g2, threads=1024))
    x = _blocks(plan, 2)
    plan.apply_blocks(*x)
    assert (lib.chain_calls, other.chain_calls) == (1, 1)
    chained = list(lib.launched)
    assert chained[1][1][19] == 1024
    assert chained[1][2][:2] == chained[0][2][10:]
    assert fused_pass.launches == 2


def test_stub_counts_pointer_forms(lib):
    """The table mask the chain is prepared with matches the pointers it
    hands the C entry for each table form: stage tables with a table
    epilogue, with the coarse table, and the 2-D tables."""
    masks = set()
    for form in ("fourstep-fwd-natural-host", "fourstep-fwd-natural-inkernel",
                 "monolithic-fwd"):
        plan = _plan(form)
        plan.apply_blocks(*_blocks(plan, 1))
        masks |= {m for _, m, _ in lib.prepared}
    assert masks == {1, 1 | 4, 1 | 8, 2}
