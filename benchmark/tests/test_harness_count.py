"""Each cell's samples, operations, bytes and ring, from its files alone
(no plan is built), against numbers worked out by hand."""

import pytest

from benchmark import count, manifest

MiB = 1 << 20
#: cell: (samples a call, slot bytes, slots, pass ops, pass bytes)
EXPECTED = {
    # 64 x 64k int16 in and out; 16 stages + the twiddle, 12 ops each
    "fft64k_b64": (64 * 65536, 32 * MiB, 8, 64 * 65536 * 17 * 12,
                   64 * 65536 * 2 * (2 + 2)),
    "fft64k_b8": (8 * 65536, 4 * MiB, 64, 8 * 65536 * 17 * 12,
                  8 * 65536 * 2 * (2 + 2)),
    # payload 65536 - 8193 + 1 = 57344; an int32 signal in, int64 out; the
    # forward 16-bit data -> 32-bit spectrum, the inverse 44-bit -> 44-bit
    "conv64k_t4": (4 * 57344, 4 * 57344 * 2 * 12, 48,
                   2 * 4 * 65536 * 17 * 12,
                   4 * 65536 * 2 * (2 + 4) + 4 * 65536 * 2 * (8 + 8)),
    "conv64k_t64": (64 * 57344, 64 * 57344 * 2 * 12, 3,
                    2 * 64 * 65536 * 17 * 12,
                    64 * 65536 * 2 * (2 + 4) + 64 * 65536 * 2 * (8 + 8)),
}


def _sizes(name):
    cell = manifest.cell(name)
    return cell.builder.sizes(cell.config, cell.traffic)


def test_every_cell_is_counted():
    assert {w["name"] for w in manifest.load()["workloads"]} <= set(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_sizes_and_work(name):
    samples, slot, slots, ops, nbytes = EXPECTED[name]
    size = _sizes(name)
    assert (size.samples_per_call, size.slot_bytes, size.slots) == (
        samples, slot, slots)
    assert (size.work["pass"].ops, size.work["pass"].bytes) == (ops, nbytes)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_ring_is_four_times_l2(name):
    assert count.ring_floor_bytes() == 4 * 50_000_000
    assert _sizes(name).ring_bytes >= count.ring_floor_bytes()


@pytest.mark.parametrize("name", ["conv64k_t4", "conv64k_t64"])
def test_product_work(name):
    blocks = EXPECTED[name][0] // 57344
    work = _sizes(name).work["product"]
    assert work.ops == blocks * 65536 * 12
    # the spectrum in at 32 bits, the product out at 44, the table once
    assert work.bytes == blocks * 65536 * 2 * (4 + 8) + 65536 * 2 * 4
    assert work.bound_by() == "bytes"


def test_bounds():
    work = _sizes("fft64k_b64").work["pass"]
    assert work.bound_by() == "operations"
    assert work.bound_ms() == pytest.approx(64 * 65536 * 17 * 12
                                            / 52.311e12 * 1e3)
    assert count.container(16) == 2 and count.container(17) == 4
    assert count.container(44) == 8
    with pytest.raises(ValueError):
        count.container(65)
