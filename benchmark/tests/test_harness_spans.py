"""The span reduction (`spans.py`) and the six span readers on numbers made
up for the test, then a tiny run of `python3 -m benchmark.spans` on each
cell on the CPU."""

import json

import pytest

from benchmark import spans as sp
from benchmark.run import read_metric
from benchmark.tests.conftest import CELLS, TINY

# (name, start, end, parent, frame, attrs), as the program's recorder drains them
STEP = [
    ("slam_step", 0, 100, -1, 0, None),     # 0
    ("track", 0, 60, 0, 0, None),           # 1
    ("host_read.odometry.rmse", 40, 50, 1, 0, None),  # 2
    ("integrate", 60, 80, 0, 0, None),      # 3
    ("hash.activate", 62, 78, 3, 0, None),  # 4
    ("hash.find", 64, 70, 4, 0, None),      # 5
    ("raycast", 80, 100, 0, 0, None),       # 6
]


def test_innermost_span_names_each_stretch():
    segs = sp.innermost_segments(STEP)
    assert segs == [(0, 40, 1), (40, 50, 2), (50, 60, 1), (60, 62, 3), (62, 64, 4),
                    (64, 70, 5), (70, 78, 4), (78, 80, 3), (80, 100, 6)]


def test_idle_by_span_intersects_exactly_and_adds_to_ancestors():
    # the card busy in [10, 45) (two ops that overlap), [66, 68) and [90, 130):
    # idle [0, 10), [45, 66), [68, 90) inside the step, none after it
    dev = [(10, 30, "a"), (20, 45, "b"), (66, 68, "c"), (90, 130, "d")]
    by = sp.idle_by_span(dev, STEP, 0, 120)
    assert by["slam_step"] == [10 + 21 + 22, 100]
    assert by["track"] == [10 + 15, 60]          # [0, 10) and [45, 60)
    assert by["host_read.odometry.rmse"] == [5, 10]  # [45, 50)
    assert by["integrate"] == [6 + 12, 20]       # [60, 66) and [68, 80)
    assert by["hash.activate"] == [4 + 10, 16]   # [62, 66) and [68, 78)
    assert by["hash.find"] == [2 + 2, 6]         # [64, 66) and [68, 70)
    assert by["raycast"] == [10, 20]             # [80, 90)
    # the window widens to the last device op: [100, 130) is outside every
    # span, and busy
    assert by[sp.OUTSIDE] == [0, 30]


def test_idle_outside_every_span_has_its_own_name():
    spans = [("integrate", 10, 20, -1, 3, None), ("raycast", 30, 40, -1, 3, None)]
    by = sp.idle_by_span([(12, 14, "k")], spans, 0, 50)
    assert by["integrate"] == [8, 10] and by["raycast"] == [10, 10]
    assert by[sp.OUTSIDE] == [30, 30]  # [0, 10), [20, 30), [40, 50)


def test_a_name_nested_in_itself_counts_once():
    spans = [("a", 0, 10, -1, 0, None), ("a", 2, 8, 0, 0, None)]
    assert sp.idle_by_span([], spans, 0, 10)["a"] == [10, 10]


def test_reduce_gives_coverage_sites_and_clock_lead():
    dev = [(10, 30, "a"), (20, 45, "b"), (66, 68, "c"), (79, 82, "void integrate_kernel(Args)"),
           (90, 130, "march_kernel<6>")]
    spans = STEP + [("k1.launch", 78, 80, 3, 0, None), ("k2.launch", 85, 95, 6, 0, None)]
    ctx, info = sp.reduce(spans, {"host_reads.hash.find": 4, "hash.probe_rounds": 2}, dev,
                          0, 120, 2, True)
    assert info["host_reads_by_site"] == {"hash.find": 2.0}
    assert info["span_coverage"] == 1.0  # every idle stretch lies in slam_step
    # each kernel starts after its launch span begins: 1 ns and 5 ns later
    assert info["clock_lead_us"] == {"k1": {"lead_us": -1 / 1e3, "kernels": 1, "spans": 1},
                                     "k2": {"lead_us": -5 / 1e3, "kernels": 1, "spans": 1}}
    assert info["idle_by_span"][0] == ["slam_step", 50e-9]
    assert ctx["span_idle"]["track"] == [25, 60]
    _, info = sp.reduce(spans, {}, dev[:3] + dev[4:], 0, 120, 2, True)
    assert info["clock_lead_us"]["k1"] is None  # a span without its kernel


def test_clock_lead_matches_each_kernel_to_the_nearest_span():
    spans = [("k1.launch", t, t + 5, -1, 0, None) for t in (100, 200, 300)]
    # the second kernel starts 3 ns before its span: a lead of 3 ns
    dev = [(110, 120, "integrate_kernel"), (197, 220, "integrate_kernel"),
           (350, 360, "integrate_kernel")]
    got = sp.clock_lead(dev, spans, "k1.launch", "integrate_kernel")
    assert got == {"lead_us": 3 / 1e3, "kernels": 3, "spans": 3}


def _ctx():
    counts = {"odometry.gn_iterations": 17, "hash.probe_rounds": 6, "hash.claim_rounds": 4,
              "host_reads.odometry.rmse": 17}
    ctx, _ = sp.reduce(STEP, counts, [(10, 45, "k"), (66, 68, "k"), (90, 130, "k")],
                       0, 120, 2, True)
    return ctx


def test_the_six_readers():
    ctx = _ctx()
    assert read_metric("idle_pct.track", ctx) == pytest.approx(100 * 25 / 60)
    assert read_metric("idle_pct.integrate", ctx) == pytest.approx(100 * 18 / 20)
    assert read_metric("idle_pct.raycast", ctx) == pytest.approx(100 * 10 / 20)
    assert read_metric("gn_iters_per_frame", ctx) == 8.5
    assert read_metric("hash_rounds_per_frame", ctx) == 5.0
    assert read_metric("host_wait_ms_per_frame", ctx) == pytest.approx(10 / 1e6 / 2)


@pytest.mark.parametrize("name", ["idle_pct.track", "idle_pct.integrate", "idle_pct.raycast",
                                  "gn_iters_per_frame", "hash_rounds_per_frame",
                                  "host_wait_ms_per_frame"])
def test_readers_find_nothing_without_the_recorder(name):
    # `drivers/slam.py`'s context as it is today, and a program with no spans
    assert read_metric(name, {"camera": {}, "steps_traced": 4}) is None
    ctx = {"spans": [], "span_counts": {}, "span_steps": 4}
    assert read_metric(name, ctx) is None


def test_unattributed_reads_are_named_by_span_and_host_op():
    ms = 1_000_000  # in ns, far beyond the clocks' tolerance
    host = [(0, 100 * ms, "aten::is_nonzero"), (10 * ms, 20 * ms, "aten::item"),
            (12 * ms, 18 * ms, "aten::_local_scalar_dense"),
            (200 * ms, 300 * ms, "aten::item"), (210 * ms, 220 * ms, "aten::_local_scalar_dense")]
    spans = [("hash.find", 190 * ms, 400 * ms, -1, 0, None),
             ("host_read.hash.find", 205 * ms, 230 * ms, 0, 0, None)]
    assert sp.unattributed_reads(host, spans, 2) == {
        f"{sp.OUTSIDE} <- aten::is_nonzero": [0.5, 6 * ms / 1e3]}


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_spans_run(capsys, cell):
    capsys.readouterr()
    assert sp.main(["--workload", cell, "--seed", "2147483913"], device="cpu",
                   overrides=TINY) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = line["metrics"]
    # the CPU profile has no device: the idle shares are left out
    assert not any(k.startswith("idle_pct.") for k in got)
    assert ("gn_iters_per_frame" in got) == (cell == "slam640.track")
    assert got["hash_rounds_per_frame"]["value"] > 0
    assert got["host_wait_ms_per_frame"]["value"] > 0
    assert all(m["value"] > 0 for m in got.values())
    info = line["info"]
    assert info["host_reads_by_site"]["hash.find"] >= 1
    # part 4's reads: every one holds a site but `drivers/slam.py`'s read of the
    # tracking flag, outside the program
    extra = [f"{sp.OUTSIDE} <- aten::is_nonzero"] if cell == "slam640.track" else []
    assert list(info["reads_without_site"]) == extra
    assert all(v[0] == 1.0 for v in info["reads_without_site"].values())
    assert set(info["recorder_cost"]) == {"span_ns_off", "span_ns_on", "count_ns_off",
                                          "count_ns_on"}


def test_device_events_are_put_back_on_the_host_clock():
    # the card's clock runs 1 % slow against the host's: a launch at host
    # time t reads t - t / 100 on the card, then the op runs 5 ns after it;
    # one op (id 9) was queued behind another and starts 40 ns late; one
    # (id 7) has no launch call in the profile
    calls, dev = {}, []
    for c, t in enumerate(range(0, 100_000, 1_000)):
        calls[c] = t
        start = t + 5 + (40 if c == 9 else 0)
        dev.append((start - start // 100, start - start // 100 + 50, f"op{c}", c))
    del calls[7]
    out, (lo, hi) = sp.aligned_device_events(dev, calls, window_ns=1_500)
    starts = {n: s for s, _, n in out}
    for c in range(100):
        # within the launch latency and the drift over the window
        assert abs(starts[f"op{c}"] - (c * 1_000 + 5 + (40 if c == 9 else 0))) <= 5 + 30
        if c in calls:
            assert starts[f"op{c}"] >= calls[c]  # no op starts before its launch
    assert lo >= 0 and 900 <= hi <= 1_000
    # a profile without launch calls stays as it was
    assert sp.aligned_device_events(dev[:2], {})[0] == [(s, e, n) for s, e, n, _ in dev[:2]]
