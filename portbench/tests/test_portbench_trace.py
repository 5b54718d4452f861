"""The idle share and the breakdown from a recorded trace."""
import pytest

from portbench.trace import Trace, union


def _trace():
    X = lambda name, cat, ts, dur, tid=1: dict(ph="X", name=name, cat=cat,
                                               ts=ts, dur=dur, pid=1, tid=tid)
    return Trace([
        X("portbench.window", "user_annotation", 100, 100),
        X("enflows.cuda.fused_coupling_fwd", "user_annotation", 105, 10),
        X("aten::add", "cpu_op", 150, 30),
        # two kernels overlapping on 130-140: counted once
        X("coupling_fwd_kernel<1>", "kernel", 110, 30, tid=7),
        X("adam_kernel", "kernel", 130, 20, tid=8),
        X("Memcpy DtoD", "gpu_memcpy", 180, 10, tid=7),
        # outside the window: clipped
        X("early", "kernel", 50, 55, tid=7),
        X("late", "kernel", 195, 50, tid=7),
    ])


def test_union_merges_overlaps():
    assert union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]


def test_busy_and_idle_count_overlap_once():
    t = _trace()
    assert t.window_s == pytest.approx(100e-6)
    # 100-105 early, 110-150 two kernels, 180-190 copy, 195-200 late
    assert t.busy_s() == pytest.approx(60e-6)
    assert t.idle_share() == pytest.approx(0.4)
    assert t.kernel_s("coupling_fwd_kernel") == pytest.approx(30e-6)
    assert t.count("kernel") == 2 and t.count("") == 5
    assert t.host_s("enflows.cuda.fused_coupling_fwd") == pytest.approx(1e-5)


def test_breakdown_names_gaps_by_host_activity():
    b = _trace().breakdown()
    assert b["device_ops"][0] == ["coupling_fwd_kernel<1>", pytest.approx(30e-6)]
    gaps = [(n, round(s * 1e6)) for n, s in b["idle_gaps"]]
    assert gaps[0] == ("aten::add", 30)
    assert sorted(gaps[1:]) == [("enflows.cuda.fused_coupling_fwd", 5),
                                ("host: outside any operation", 5)]
