"""The span and counter recorder of utils/timer.py on the frame step: a
test-size `slam_step` over two frames, and `integrate_frame` +
`synthesize_model_frame` with a given pose, each run with the recorder off
and on under the CPU profiler.

Bars: off, nothing is recorded and the outputs are bit-equal to those of
the run with it on; the profiler counts as many host reads
(`aten::_local_scalar_dense`) either way, and the `host_reads.<site>`
counters sum to that count; the span tree has one root a frame carrying
its frame id, the layers under it and one `odometry.level` a level; the
Gauss-Newton and hash counters equal the loops' passes; a span's stamps
and the profiler's agree to 50 us.
"""

import dataclasses
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from open3d_tpu_torch.core import hashmap as hm
from open3d_tpu_torch.core import lie
from open3d_tpu_torch.data import synthetic as syn
from open3d_tpu_torch.models import dense_slam as ds
from open3d_tpu_torch.ops.kernels import point_to_plane as p2p
from open3d_tpu_torch.utils import timer as tm

torch.set_num_threads(2)
HOST_READ = "aten::_local_scalar_dense"
CFG = ds.SLAMConfig(voxel_size=0.02, block_count=2048, frame_block_capacity=512)


@pytest.fixture(autouse=True)
def _recorder_off():
    tm.disable()
    tm.drain()
    yield
    tm.disable()
    tm.drain()


@pytest.fixture(scope="module")
def frames():
    d, c, e, intr = syn.render_sequence(2, span=0.25, device="cpu")
    return d, c, e, intr


def _host_reads(prof) -> int:
    return sum(1 for e in prof.events() if e.name == HOST_READ)


def _run(frames, on: bool, tracked: bool):
    """Two frames through the step (tracked) or through integrate_frame and
    synthesize_model_frame at the true poses; returns (outputs, profiler
    host reads of each frame, spans and counters of each frame)."""
    d, c, e, intr = frames
    model = ds.create_model(CFG, T_init=lie.invert_se3(e[0]), device="cpu")
    ray = torch.zeros_like(d[0])
    outs, reads, recs = [], [], []
    if on:
        tm.enable()
    for i in range(2):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            if tracked:
                res = ds.slam_step(model, d[i], c[i], ray, intr)
                model, ray = res.model, res.raycast_depth
            else:
                model = dataclasses.replace(model, T_frame_to_world=lie.invert_se3(e[i]))
                model, _ = ds.integrate_frame(model, d[i], c[i], intr)
                ray = ds.synthesize_model_frame(model, intr).depth
                model = dataclasses.replace(model, frame_id=model.frame_id + 1)
        reads.append(_host_reads(prof))
        recs.append(tm.drain())
        outs.append((model.T_frame_to_world.clone(), ray.clone(), model.vbg.table.clone(),
                     model.vbg.tw.clone(), model.vbg.color.clone()))
    tm.disable()
    return outs, reads, recs


@pytest.fixture(scope="module")
def runs(frames):
    """{(tracked, on): _run(...)}; the tracked run on also counts the
    Gauss-Newton loop's passes by the point-to-plane row function's calls
    (one a pass, and one a frame for the final metrics)."""
    out = {}
    for tracked in (True, False):
        for on in (False, True):
            tm.disable()
            tm.drain()
            calls = []
            rows = p2p.rows_plain
            if tracked and on:
                def counted(*a, **k):
                    calls.append(1)
                    return rows(*a, **k)
                p2p.rows_plain = counted
            try:
                out[tracked, on] = _run(frames, on, tracked) + (len(calls),)
            finally:
                p2p.rows_plain = rows
    tm.disable()
    tm.drain()
    return out


@pytest.mark.parametrize("tracked", [True, False], ids=["slam_step", "known_pose"])
def test_off_records_nothing_and_outputs_are_bit_equal(runs, tracked):
    off, on = runs[tracked, False], runs[tracked, True]
    assert all(rec == ([], {}) for rec in off[2])
    assert all(rec[0] and rec[1] for rec in on[2])
    for a, b in zip(off[0], on[0]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("tracked", [True, False], ids=["slam_step", "known_pose"])
def test_spans_add_no_host_read_and_every_read_has_a_site(runs, tracked):
    off, on = runs[tracked, False], runs[tracked, True]
    assert off[1] == on[1] and min(on[1]) > 0
    for n, (spans, counts) in zip(on[1], on[2]):
        sites = {k: v for k, v in counts.items() if k.startswith("host_reads.")}
        assert sum(sites.values()) == n
        assert {"host_reads.hash.find", "host_reads.hash.claim"} <= set(sites)
        assert ("host_reads.odometry.rmse" in sites) == tracked
        # one span a read, under the span of the layer that reads
        assert sum(1 for s in spans if s[0].startswith("host_read.")) == n


def _children(spans, i):
    return [s[0] for s in spans if s[3] == i]


def test_span_tree_of_the_step(runs):
    _, _, recs, passes = runs[True, True]
    gn = 0
    for frame, (spans, counts) in enumerate(recs):
        roots = [i for i, s in enumerate(spans) if s[3] == -1]
        assert [spans[i][0] for i in roots] == ["slam_step"]
        assert all(s[4] == frame for s in spans)  # the frame id, inherited
        root = roots[0]
        assert _children(spans, root) == ["track", "integrate", "raycast"]
        assert all(s[1] <= s[2] for s in spans)
        for s in spans:
            if s[3] >= 0:
                p = spans[s[3]]
                assert p[1] <= s[1] and s[2] <= p[2]
        track = _children(spans, root).index("track")
        track = [i for i, s in enumerate(spans) if s[3] == root][track]
        assert [s[0] for s in spans if s[3] == track] == [
            "odometry.pyramid", "odometry.level", "odometry.level", "odometry.level",
            "odometry.final"]
        assert [s[5] for s in spans if s[0] == "odometry.level"] == [
            {"level": 2}, {"level": 1}, {"level": 0}]
        assert counts["odometry.gn_iterations"] == counts["host_reads.odometry.rmse"]
        gn += counts["odometry.gn_iterations"]
        names = {s[0] for s in spans}
        assert {"integrate.touch", "hash.activate", "hash.find", "k1.launch",
                "raycast.tile_lists", "k2.launch", "raycast.maps"} <= names
    # the row function runs once a pass and once for the final metrics
    assert gn == passes - len(recs)


def test_known_pose_layers_are_roots_with_the_frame_id(runs):
    _, _, recs, _ = runs[False, True]
    for frame, (spans, counts) in enumerate(recs):
        roots = [s for s in spans if s[3] == -1]
        assert [s[0] for s in roots] == ["integrate", "raycast"]
        assert all(s[4] == frame for s in spans)
        assert "odometry.gn_iterations" not in counts
        assert counts["hash.probe_rounds"] >= 1 and counts["hash.claim_rounds"] >= 1


def _colliding_keys(C: int, n: int):
    """n packed keys with one home slot in a table of C slots."""
    g = torch.arange(-8, 8, dtype=torch.int32)
    coords = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    keys = hm.pack_coords(coords)
    home = hm._home(keys, C)
    h = int(torch.mode(home).values)
    same = keys[home == h][:n]
    assert same.shape[0] == n
    return same, h


def test_hash_counters_equal_the_rounds():
    C, n = 64, 4
    keys, h = _colliding_keys(C, n)
    tm.enable()
    table, slot, ok = hm.activate(hm.make_table(C, device="cpu"), keys)
    _, counts = tm.drain()
    assert bool(ok.all())
    assert slot.tolist() == [(h + i) % C for i in range(n)]
    # activate's find: one probe meets the empty home slot; then key i is
    # claimed in round 2 i + 1 (the lanes that lost see the slot taken in
    # the next round and move on): 2 n - 1 rounds, and a read before each
    # round and one to leave, in each loop
    assert counts == {"hash.probe_rounds": 1, "host_reads.hash.find": 2,
                      "hash.claim_rounds": 2 * n - 1, "host_reads.hash.claim": 2 * n}
    # a lookup of the chain finds key i at probe i
    slot2, found = hm.find(table, keys)
    spans, counts = tm.drain()
    assert bool(found.all()) and torch.equal(slot2, slot)
    assert counts == {"hash.probe_rounds": n, "host_reads.hash.find": n + 1}
    assert [s[0] for s in spans if s[3] == -1] == ["hash.find"]


def test_off_is_a_shared_no_op():
    assert tm.span("a") is tm.span("b", 3, level=1)
    with tm.span("a"):
        tm.count("c")
        assert tm.host_read("site", torch.tensor(2.5)) == 2.5
    assert tm.drain() == ([], {})


def test_drain_refuses_an_open_span():
    tm.enable()
    with tm.span("outer", 7):
        with tm.span("inner"):
            with pytest.raises(RuntimeError):
                tm.drain()
    spans, _ = tm.drain()
    assert [(s[0], s[3], s[4]) for s in spans] == [("outer", -1, 7), ("inner", 0, 7)]


def test_span_clock_is_the_profilers():
    """A span between two record_function blocks, one inside it and one
    around it, lies between their profiler intervals to 50 us: the
    recorder and the profiler stamp on one clock."""
    tm.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(4):
            with record_function("around"):
                with tm.span("span"):
                    with record_function("inside"):
                        time.sleep(0.005)
    spans, _ = tm.drain()
    ev = {name: sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                       for e in prof.profiler.kineto_results.events() if e.name() == name)
          for name in ("around", "inside")}
    assert len(spans) == len(ev["around"]) == len(ev["inside"]) == 4
    tol = 50_000
    for (_, s0, s1, *_), (a0, a1), (i0, i1) in zip(spans, ev["around"], ev["inside"]):
        assert a0 - tol <= s0 <= i0 + tol
        assert i1 - tol <= s1 <= a1 + tol
