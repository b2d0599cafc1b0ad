"""The port's config-5 line and channel weak scaling (bench_torch.sharded)
on gloo CPU processes: the twin of tests/test_bench_config5.py, which holds
bench.py's bench_config5 on the 8-device virtual CPU mesh.  The line runs
the sharded four-step at a small n over D processes started by
intfftk_tpu_torch.entry.spawn_cpu, its bits held to the golden model inside
the line (``bits_ok``); the weak line's metric is named by its quantity
under each mode.  Every spawn has a time limit, so a hung group fails."""

import pytest

from bench_torch import sharded
from bench_torch.__main__ import parse

#: seconds a spawned group may take before it is ended and the test fails
SPAWN_TIMEOUT = 240


@pytest.mark.parametrize("d", [2, 4])
def test_config5_gloo_mesh(d):
    out = sharded.cpu_mesh(d, "config5", n=1 << 12, timeout=SPAWN_TIMEOUT)
    assert out["bits_ok"] is True
    assert out["devices"] == d
    assert out["virtual"] is True          # flagged: not a rate claim
    assert out["msamples_per_sec"] > 0
    assert (out["n"], out["batch"], out["kernel"]) == (4096, 2, "pallas")
    assert out["line"] == "c5_four_step" and out["device"] == "cpu"


@pytest.mark.parametrize("d", [2, 4])
def test_weak_channel_gloo_mesh(d):
    out = sharded.cpu_mesh(d, "weak", n=64, per_rank=16,
                           timeout=SPAWN_TIMEOUT)
    assert out["metric"] == "weak_scaling_efficiency"
    assert out["mode"] == "channel" and out["virtual_devices"] is True
    points = [k for k in range(1, d + 1) if d % k == 0]
    assert list(out["points"]) == [str(k) for k in points]
    assert out["points"]["1"] == 1.0
    assert out["value"] == min(out["points"].values()) > 0
    assert all(out["msamples_per_sec"][str(k)] > 0 for k in points)


def test_weak_line_names_follow_the_quantity():
    """One card: batch retention; across ranks: weak scaling efficiency.
    The two never share a metric name."""
    one = sharded.weak_line("batch_retention", {8: 1.0, 16: 1.4, 32: 1.7})
    assert one["metric"] == one["mode"] == "batch_retention"
    assert one["value"] == 1.0 and list(one["points"]) == ["8", "16", "32"]
    assert "virtual_devices" not in one and "not_run" not in one
    many = sharded.weak_line("channel", {1: 1.0, 2: 0.9}, virtual=True)
    assert (many["metric"], many["mode"]) == ("weak_scaling_efficiency",
                                              "channel")
    assert many["value"] == 0.9 and many["virtual_devices"] is True
    assert sharded.weak_line("channel", {1: 1.0})["metric"] != one["metric"]
    with pytest.raises(ValueError, match="weak mode"):
        sharded.weak_line("batch", {8: 1.0})


def test_cpu_mesh_flags():
    assert parse(["--config5", "--cpu-mesh", "2"]).cpu_mesh == 2
    assert parse(["--weak", "--cpu-mesh", "4"]).weak
    assert parse(["--config5"]).cpu_mesh is None
    with pytest.raises(SystemExit):
        parse(["--cpu-mesh", "2"])
    with pytest.raises(SystemExit):
        parse(["--config5", "--weak"])
