"""The traced sub-window's arithmetic on synthetic events."""

from types import SimpleNamespace

import pytest

from benchmark import tracewin as profile


def ev(name, a, b, cuda=False):
    from torch.autograd import DeviceType

    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=a, end=b),
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU)


def test_union_and_gaps():
    iv = [(0, 10), (5, 12), (20, 30), (25, 26), (40, 41)]
    assert profile.merge_intervals(iv) == [[0, 12], [20, 30], [40, 41]]
    assert profile.busy_time(iv) == 12 + 10 + 1
    assert profile.gaps(iv, -5, 50) == [(-5, 0), (12, 20), (30, 40),
                                        (41, 50)]
    assert profile.gaps([], 0, 3) == [(0, 3)]


def test_host_calls():
    names = ["cudaLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
             "cudaMemcpyAsync", "cudaStreamSynchronize", "cudaMemcpy",
             "aten::add"]
    out = profile.host_calls([ev(n, 0, 1) for n in names])
    assert out == {"kernel": 2, "graph": 1, "memcpy": 1, "wait": 2}


def test_label_gaps_innermost():
    host = [(0, 100, "outer"), (10, 30, "inner"), (12, 14, "tiny")]
    assert profile.label_gaps(host, [(15, 25), (50, 60), (200, 210)]) == [
        "inner", "outer", "host_untraced"]


def test_read_and_breakdown():
    events = [ev("aten::mm", 0, 100), ev("cudaLaunchKernel", 1, 2),
              ev("cudaLaunchKernel", 3, 4), ev("cudaGraphLaunch", 7, 8),
              ev("cudaStreamSynchronize", 60, 90),
              ev("k1", 10, 30, True), ev("k1", 40, 50, True),
              ev("k2", 45, 55, True)]
    p = profile.Profile()
    p.prof = SimpleNamespace(events=lambda: events)
    p.wall_s = 1e-4
    r = p.read()
    assert r["busy_s"] == pytest.approx((20 + 15) / 1e6)
    assert r["device_ops"]["k1"] == [2, pytest.approx(30 / 1e6)]
    assert r["host_calls"]["kernel"] == 2 and r["host_calls"]["graph"] == 1
    # gaps: 0-10, 30-40 (aten::mm) and 55-100 (the synchronize at 75)
    assert r["idle_by_host"]["cudaStreamSynchronize"] == pytest.approx(
        45 / 1e6)
    assert r["idle_by_host"]["aten::mm"] == pytest.approx(20 / 1e6)
    b = profile.breakdown(r)
    assert b["device_ops"][0][0] == "k1" and len(b["idle_gaps"]) == 2
    assert b["idle_gaps"][0] == ["cudaStreamSynchronize",
                                 pytest.approx(45 / 1e6)]
