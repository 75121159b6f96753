"""The program's own spans and counters over traced steps of a SLAM cell
(`open3d_tpu_torch/utils/timer.py`'s recorder), reduced to the numbers the
span readers take (`metrics/idle_pct.{track,integrate,raycast}.py`,
`gn_iters_per_frame.py`, `hash_rounds_per_frame.py`,
`host_wait_ms_per_frame.py`).

    python3 -m benchmark.spans --workload <cell> --seed <n>

sets up a session of the cell as `drivers/slam.py` does and runs, after
the warm-up, four traced parts, each printing nothing until the end:
1. `trace_steps` steps under the device trace and the layers' event
   pairs, the recorder off (`drivers/slam.py`'s first traced part);
2. `host_trace_steps` steps under the host's trace as well, the recorder
   off (its second part: `aten::_local_scalar_dense` a frame);
3. `trace_steps` steps under the device trace alone with the recorder on:
   the spans, the counters and the card's intervals on one clock;
4. `host_trace_steps` steps under the host's trace with the recorder on:
   each host read of the profiler matched to a `host_read.<site>` span.
Its last line is JSON: the six span metrics of part 3 (the idle shares
only with a card), `info` (reads a frame by site, the idle by span, the
coverage, part 3's cost against part 1, the launch spans' lead over their
kernels, the reads no site holds, the recorder's cost a call) and the
device. A program without the recorder gives no span metric.

The recorder stamps with the host's epoch clock (`time.time_ns`), as the
profiler stamps the host's side of every launch (the CUDA runtime's
`cudaLaunchKernel`, `cudaMemcpyAsync`, ...): each launch lies inside the
program's span around it. The card's own timestamps, converted by the
profiler to the same clock, drift from it within a profile of a few
seconds (by up to tens of ms on an H100 behind a virtual machine's
clock), so `aligned_device_events` puts each device operation back on
the host's clock by the launches around it before anything is
intersected with a span; `clock_lead` then checks K1 and K2 against the
launch spans the program opened for them.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import re
import sys
import time
from collections import defaultdict, deque

OUTSIDE = "(outside spans)"  # the name of idle time no span holds
ROOTS = ("slam_step", "integrate", "raycast")  # the frame step's root spans
HOST_READ_SPAN = "host_read."
TOL_NS = 50_000  # the profiler's host clock against the recorder's (tests/test_torch_tracing.py)
LAUNCHES = {"k1": ("k1.launch", "integrate_kernel"), "k2": ("k2.launch", "march_kernel")}
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaMemcpyAsync", "cudaMemsetAsync")
ALIGN_WINDOW_NS = 500_000
TRACK, KNOWN = "slam640.track", "slam640.known_pose"
# each span metric: its unit and the cells whose traffic exercises it
SPAN_METRICS = {
    "idle_pct.track": ("%", (TRACK,)),
    "idle_pct.integrate": ("%", (TRACK, KNOWN)),
    "idle_pct.raycast": ("%", (TRACK, KNOWN)),
    "gn_iters_per_frame": ("iterations/frame", (TRACK,)),
    "hash_rounds_per_frame": ("rounds/frame", (TRACK, KNOWN)),
    "host_wait_ms_per_frame": ("ms/frame", (TRACK, KNOWN)),
}


def profile_events(prof):
    """([(start, end, name, correlation id)] of the card's operations, {id:
    start} of the host's launch calls) of a profile, on the profiler's clocks."""
    import torch

    dev, calls = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            s = e.start_ns()
            dev.append((s, s + e.duration_ns(), e.name(), e.correlation_id()))
        elif e.name() in LAUNCH_CALLS:
            calls[e.correlation_id()] = e.start_ns()
    dev.sort()
    return dev, calls


def aligned_device_events(dev, calls, window_ns: int = ALIGN_WINDOW_NS):
    """([(start, end, name)] of the card's operations on the host's clock,
    the offsets' range in ns). An operation cannot start before the host
    call that launched it began, so each launched operation bounds the
    offset from below (call start - device start); the card idles most of
    the time, so most operations start a few us after their call and the
    largest bound within `window_ns` of an operation is the offset there,
    to within the launch latency and the drift over the window."""
    anchors = [(s, calls[c] - s) for s, _, _, c in dev if c in calls]
    if not anchors:
        return [(s, e, n) for s, e, n, _ in dev], (0, 0)
    out, offs = [], []
    lo = hi = 0
    window = deque()  # indices into anchors, bounds decreasing
    for s, e, n, _ in dev:
        while hi < len(anchors) and anchors[hi][0] <= s + window_ns:
            while window and anchors[window[-1]][1] <= anchors[hi][1]:
                window.pop()
            window.append(hi)
            hi += 1
        while lo < hi and anchors[lo][0] < s - window_ns:
            lo += 1
        while window and window[0] < lo:
            window.popleft()
        if window:
            off = anchors[window[0]][1]
        else:  # no launch within the window: the nearest launch's bound
            near = [j for j in (lo - 1, hi) if 0 <= j < len(anchors)]
            off = anchors[min(near, key=lambda j: abs(anchors[j][0] - s))][1]
        offs.append(off)
        out.append((s + off, e + off, n))
    out.sort()
    return out, (min(offs), max(offs))


def recorder():
    """The program's recorder module, or None where the program has none."""
    from open3d_tpu_torch.utils import timer

    return timer if hasattr(timer, "drain") else None


def innermost_segments(spans):
    """[(start, end, span index)] covering the spans' time, each stretch
    named by the innermost span open over it. Spans are properly nested
    (one thread, entered and left in order)."""
    ev = []
    for i, s in enumerate(spans):
        ev.append((s[1], 1, i))
        ev.append((s[2], 0, -i))  # at one instant, ends first, the inner first
    ev.sort()
    out, stack, t = [], [], None
    for when, start, i in ev:
        if stack and when > t:
            out.append((t, when, stack[-1]))
        if start:
            stack.append(i)
        else:
            stack.remove(-i)
        t = when
    return out


def idle_stretches(intervals, lo: int, hi: int):
    """[(start, end)] of [lo, hi], widened to the device intervals, in
    which nothing ran on the card."""
    from benchmark import trace as tr

    if intervals:
        lo, hi = min(lo, intervals[0][0]), max(hi, max(e for _, e, _ in intervals))
    out, t = [], lo
    for s, e in tr.merged(intervals, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def idle_by_span(intervals, spans, lo: int, hi: int) -> dict:
    """{span name: [idle ns, wall ns]}, each including the span's children:
    the card's idle stretches of [lo, hi] intersected exactly with the
    innermost span open over them, added to that span and to each of its
    ancestors (once a name). Idle time outside every span is counted under
    OUTSIDE, whose wall is the window's time outside every span."""
    idle = defaultdict(int)
    gaps = idle_stretches(intervals, lo, hi)
    segs = innermost_segments(spans)
    names_of = {}

    def names(i):
        if i not in names_of:
            got, j = [], i
            while j >= 0:
                if spans[j][0] not in got:
                    got.append(spans[j][0])
                j = spans[j][3]
            names_of[i] = got
        return names_of[i]

    j = 0
    for a, b in gaps:
        covered = 0
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            s, e, i = segs[k]
            piece = min(b, e) - max(a, s)
            if piece > 0:
                covered += piece
                for name in names(i):
                    idle[name] += piece
            k += 1
        idle[OUTSIDE] += (b - a) - covered
    wall = defaultdict(int)
    for s in spans:
        if s[3] < 0 or s[0] not in names(s[3]):  # the outermost span of its name
            wall[s[0]] += s[2] - s[1]
    if gaps or intervals:
        w_lo = min([lo] + [s for s, _, _ in intervals])
        w_hi = max([hi] + [e for _, e, _ in intervals])
        in_spans = sum(e - s for s, e, _ in segs)
        wall[OUTSIDE] = (w_hi - w_lo) - in_spans
    return {name: [idle.get(name, 0), wall[name]] for name in wall}


def clock_lead(intervals, spans, span_name: str, kernel: str):
    """{"lead_us": the largest time by which a kernel named `kernel`
    started before the launch span `span_name` nearest to it began (each
    kernel matched to the span whose start is nearest its own), "kernels",
    "spans": how many of each}; None without either. A negative lead:
    every kernel started after its span began."""
    pat = re.compile(r"(?<![A-Za-z0-9_])" + re.escape(kernel) + r"(?![A-Za-z0-9_])")
    starts = sorted(s for s, _, name in intervals if pat.search(name))
    opens = sorted(s[1] for s in spans if s[0] == span_name)
    if not starts or not opens:
        return None
    lead = None
    for k in starts:
        i = bisect.bisect_left(opens, k)
        o = min(opens[max(i - 1, 0):i + 1], key=lambda o: abs(o - k))
        lead = o - k if lead is None else max(lead, o - k)
    return {"lead_us": lead / 1e3, "kernels": len(starts), "spans": len(opens)}


def reduce(spans, counts, intervals, lo: int, hi: int, steps: int, device: bool):
    """(ctx entries for the span readers, info) of one traced part."""
    ctx = {"spans": spans, "span_counts": counts, "span_steps": steps}
    sites = {k[len("host_reads."):]: v / steps for k, v in sorted(counts.items())
             if k.startswith("host_reads.")}
    info = {"host_reads_by_site": sites}
    if device:
        by = idle_by_span(intervals, spans, lo, hi)
        ctx["span_idle"] = by
        total = sum(e - s for s, e in idle_stretches(intervals, lo, hi))
        ranked = sorted(((v[0], k) for k, v in by.items()), reverse=True)[:10]
        info["idle_by_span"] = [[k, ns / 1e9] for ns, k in ranked]
        roots = [(s[0], s[1], s[2], -1) + tuple(s[4:]) for s in spans
                 if s[3] < 0 and s[0] in ROOTS]
        outside = idle_by_span(intervals, roots, lo, hi).get(OUTSIDE, [0, 0])[0]
        info["span_coverage"] = (total - outside) / total if total else None
        info["clock_lead_us"] = {k: clock_lead(intervals, spans, sp, kern)
                                 for k, (sp, kern) in LAUNCHES.items()}
    return ctx, info


def unattributed_reads(host, spans, steps: int) -> dict:
    """{"<innermost span> <- <host op over the read>": [reads a frame, mean
    us a read]} of the profiler's host reads that no `host_read.<site>`
    span holds."""
    from benchmark import trace as tr

    reads = [(s, e) for s, e, n in host if n == tr.HOST_READ_OP]
    held = sorted((s[1], s[2]) for s in spans if s[0].startswith(HOST_READ_SPAN))
    segs = innermost_segments(spans)
    out, took = defaultdict(int), defaultdict(int)
    for s, e in reads:
        if any(a - TOL_NS <= s and e <= b + TOL_NS for a, b in held):
            continue
        where = next((spans[i][0] for a, b, i in segs if a <= s < b), OUTSIDE)
        over = [(hs, n) for hs, he, n in host
                if hs <= s and e <= he and n not in (tr.HOST_READ_OP, "aten::item")]
        op = max(over)[1] if over else "-"
        out[f"{where} <- {op}"] += 1
        took[f"{where} <- {op}"] += e - s
    return {k: [v / steps, took[k] / v / 1e3] for k, v in sorted(out.items())}


def recorder_cost(rec, n: int = 1000, reps: int = 100) -> dict:
    """ns a call of `span` (entered and left) and of `count`, off and on,
    over `reps` batches of `n` calls, each batch drained as a traced part
    is."""
    out = {}
    for key in ("off", "on"):
        t_span = t_count = 0
        for _ in range(reps):
            if key == "on":
                rec.enable()
            t = time.perf_counter_ns()
            for _ in range(n):
                with rec.span("cost"):
                    pass
            t_span += time.perf_counter_ns() - t
            t = time.perf_counter_ns()
            for _ in range(n):
                rec.count("cost")
            t_count += time.perf_counter_ns() - t
            rec.disable()
            rec.drain()
        out[f"span_ns_{key}"], out[f"count_ns_{key}"] = t_span / n / reps, t_count / n / reps
    return out


def main(argv=None, device=None, overrides=None) -> int:
    """`device` and `overrides` serve the CPU tests, as in `run.main`."""
    from benchmark import run

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; the cells are {sorted(cells)}",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]
    overrides = overrides or {}
    cfg = {**run.load_json(run.HERE / "configs" / f"{cell['config']}.json"),
           **overrides.get("config", {})}
    traffic = {**run.load_json(run.HERE / "traffic" / f"{cell['traffic']}.json"),
               **overrides.get("traffic", {})}
    if traffic["driver"] != "slam":
        print(f"{args.workload}: the spans are read on the cells of `drivers/slam.py`",
              file=sys.stderr)
        return 2

    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace as tr
    from benchmark.drivers import slam

    if device is None:
        if not torch.cuda.is_available():
            print(f"{args.workload} needs a CUDA card", file=sys.stderr)
            return 2
        device = "cuda"
    dev = torch.device(device)
    rec = recorder()
    depth, color, poses = slam.make_frames(cfg, traffic, dev)
    sess = slam.Session(cfg, traffic, depth, color, poses,
                        slam.stream_ids(args.seed, depth.shape[0]), dev)
    k = 0
    for _ in range(traffic["warmup_steps"]):
        sess.step(k, keep=False)
        k += 1
    n_dev, n_host = traffic["trace_steps"], traffic["host_trace_steps"]
    cuda = [ProfilerActivity.CUDA] if dev.type == "cuda" else []

    def part(steps, acts, on, patch=None):
        """`steps` steps under the profiler (and `patch`), the recorder
        `on` or off: (profile, host window start and end ns, s a step,
        (spans, counters))."""
        nonlocal k
        with contextlib.ExitStack() as stack:
            prof = stack.enter_context(profile(activities=acts))
            if patch is not None:
                stack.enter_context(patch)
            if on:
                rec.enable()
                stack.callback(rec.disable)
            lo, t = time.time_ns(), time.perf_counter()
            for _ in range(steps):
                sess.step(k, keep=False)
                k += 1
            hi, wall = time.time_ns(), time.perf_counter() - t
        return prof, lo, hi, wall / steps, rec.drain() if on else ([], {})

    timer = tr.LayerTimer(dev)
    _, _, _, step1, _ = part(n_dev, cuda or [ProfilerActivity.CPU], False,
                             timer.patched(sess.layer_targets()))
    prof, _, _, _, _ = part(n_host, [ProfilerActivity.CPU] + cuda, False)
    reads2 = tr.count_host(tr.host_events(prof), 0, tr.END, tr.HOST_READ_OP) / n_host
    info = {"host_reads_per_frame_part2": reads2, "step_ms_part1": step1 * 1e3}
    ctx = {}
    if rec is not None:
        prof, lo, hi, step3, (spans, counts) = part(n_dev, cuda or [ProfilerActivity.CPU], True)
        intervals, offs = aligned_device_events(*profile_events(prof)) if cuda else ([], (0, 0))
        ctx, more = reduce(spans, counts, intervals, lo, hi, n_dev, bool(cuda))
        info.update(more)
        info["device_clock_offset_ms"] = [offs[0] / 1e6, offs[1] / 1e6]
        info["step_ms_part3"] = step3 * 1e3
        info["span_on_cost"] = step3 / step1
        info["spans_per_frame"] = len(spans) / n_dev
        prof, _, _, _, (spans4, _) = part(n_host, [ProfilerActivity.CPU] + cuda, True)
        host = tr.host_events(prof)
        info["host_reads_per_frame_part4"] = tr.count_host(host, 0, tr.END,
                                                           tr.HOST_READ_OP) / n_host
        info["reads_without_site"] = unattributed_reads(host, spans4, n_host)
        info["recorder_cost"] = recorder_cost(rec)
    metrics = {}
    for name, (unit, cells_of) in SPAN_METRICS.items():
        v = run.read_metric(name, ctx) if cell["name"] in cells_of else None
        if v is not None:
            metrics[name] = {"value": v, "unit": unit}
    dinfo = run.device_info(dev, cell["chips"])
    line = {"workload": args.workload, "seed": args.seed, "metrics": metrics, "info": info,
            "device": dinfo}
    print(json.dumps(line), flush=True)
    return 0



if __name__ == "__main__":
    sys.exit(main())
