"""The window, roofline and idle arithmetic on numbers made up for the
test."""

import pytest

from benchmark import trace as tr
from benchmark.counts import k1, k2, peaks
from benchmark.drivers.slam import Samples, window_numbers
from benchmark.frames import ping_pong
from benchmark.run import read_metric


def test_frame_ms_is_the_whole_window_over_its_frames():
    # three frames of 10, 50 and 30 ms with host gaps between them: the
    # window's 100 ms over 3 frames, not a mean of the frames' latencies
    got = window_numbers(5.0, 5.1, [0.010, 0.050, 0.030])
    assert got["frame_ms"] == pytest.approx(100.0 / 3)
    assert got["frame_p95_ms"] == pytest.approx(48.0)


def test_union_counts_overlap_once_and_clips_to_the_window():
    ivs = [(0, 10, "a"), (5, 15, "b"), (20, 30, "c"), (95, 120, "d")]
    assert tr.merged(ivs, 0, 100) == [(0, 15), (20, 30), (95, 100)]
    assert tr.busy_ns(ivs, 0, 100) == 30


def test_idle_gaps_are_named_by_the_innermost_host_op():
    dev = [(0, 10, "k"), (50, 60, "k")]
    host = [(5, 70, "step"), (20, 45, "aten::_local_scalar_dense")]
    gaps = tr.idle_gaps(dev, 0, 100, host)
    assert gaps[0] == ["host idle", 40e-9]
    assert gaps[1] == ["aten::_local_scalar_dense", 40e-9]


def test_kernel_names_match_whole_identifiers():
    ivs = [(0, 2_000_000, "void (anonymous namespace)::march_kernel<6>(MarchArgs)"),
           (3_000_000, 4_000_000, "raymarch_kernel(int const*)")]
    assert tr.kernel_ms(ivs, 0, 10 ** 9, "march_kernel") == [2.0]


def test_idle_share():
    assert read_metric("idle_pct.frame", {"busy_s": 0.25, "window_s": 1.0}) == 75.0
    assert read_metric("idle_pct.frame", {}) is None


def test_k1_roofline_is_bound_over_kernel_time():
    ctx = {"kernels": {"integrate_kernel": [0.02, 0.03]}, "k1_live": [500, 700],
           "k1_entries": 4096, "camera": {"width": 640, "height": 480}}
    want = 100 * (k1.bound(500, 4096, 640 * 480) + k1.bound(700, 4096, 640 * 480)) / 0.05
    assert read_metric("k1_roofline_pct", ctx) == pytest.approx(want)
    # 700 live blocks: 45.9 MB of rows, 65.5 kB of list, 2.46 MB of frame
    assert k1.bound(700, 4096, 640 * 480) == pytest.approx(
        (700 * 65536 + 4096 * 16 + 640 * 480 * 8) / peaks.BYTES_PER_S * 1e3)
    ctx["kernels"]["integrate_kernel"].append(0.01)  # a launch no step accounts for
    assert read_metric("k1_roofline_pct", ctx) is None


def test_k2_roofline_reads_the_sampled_steps_only():
    st = {"sectors_sampled": 1000, "pairs_visited": 2000, "ray_blocks": 30000,
          "crossings": 5000, "tiles": 1200}
    ctx = {"kernels": {"march_kernel": [0.05, 0.9, 0.07, 0.9]}, "k2_stats": {0: st, 2: st},
           "steps_traced": 4, "camera": {"width": 640, "height": 480}}
    assert read_metric("k2_roofline_pct", ctx) == pytest.approx(
        100 * 2 * k2.bound(st, 640, 480) / 0.12)


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert peaks.bound_ms(3.35e9, 0) == pytest.approx(1.0)
    assert peaks.bound_ms(0, 67e9) == pytest.approx(1.0)
    assert peaks.bound_ms(3.35e9, 2 * 67e9) == pytest.approx(2.0)


def test_stream_plays_forward_then_back():
    assert [ping_pong(i, 4) for i in range(9)] == [0, 1, 2, 3, 2, 1, 0, 1, 2]


def test_samples_come_every_stride_from_a_seeded_offset():
    s = Samples(2147483913, 3, 10)
    got = [k for k in range(100) if k in s]
    assert len(got) == 10 and got[0] >= 3 and all(b - a == 10 for a, b in zip(got, got[1:]))
