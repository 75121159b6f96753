"""Run one cell of the benchmark and print its result as the last line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. The cell (`BENCHMARK.json`'s `workloads`) names a configuration
(`configs/<config>.json`) and a traffic mix (`traffic/<mix>.json`, whose
`driver` names `drivers/<driver>.py`); its limits of `correct` are in
`limits/<cell>.json`, and each per-layer metric's reader in
`metrics/<metric>.py`. With `--trace 0` the line carries the cell's
end-to-end metrics, with `--trace 1` its per-layer metrics, the device's
busy time and a breakdown. Every run then compares what its timed path
produced with the plain reference and prints each number compared beside
its limit, last on standard error and last in the line.

Without the card(s) the cell asks for, the run exits with code 2 and
prints no result. So does a run in whose process JAX, jaxlib, flax or the
JAX package (`open3d_tpu`) was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "open3d_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_metrics(bench: dict, kind: str, cell: str):
    """The entries of `end_to_end` or `per_layer` that the cell reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def read_metric(name: str, ctx: dict):
    """The metric's reader (`metrics/<name>.py`, `read(ctx)`), or None where
    it finds nothing to read."""
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(dev, chips: int) -> dict:
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips}


def main(argv=None, device=None, overrides=None) -> int:
    """`device` and `overrides` ({"config": {...}, "traffic": {...},
    "limits": {...}}, merged over the files) serve the CPU tests; a run
    from the command line takes neither."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; the cells are {sorted(cells)}",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]
    overrides = overrides or {}
    cfg = {**load_json(HERE / "configs" / f"{cell['config']}.json"), **overrides.get("config", {})}
    traffic = {**load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
               **overrides.get("traffic", {})}
    limits = {**load_json(HERE / "limits" / f"{cell['name']}.json"), **overrides.get("limits", {})}

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    dev = torch.device(device)
    # the configuration runs the fused integrate K1; this switch would take K4
    os.environ.pop("O3DTPU_INTEGRATE_V1", None)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    out, ctx, numbers, info = driver.run(cfg, traffic, limits, args.seed, args.seconds,
                                         bool(args.trace), dev, T0)

    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the port must not load JAX or the JAX package",
              file=sys.stderr)
        return 2

    if args.trace:
        metrics = {}
        for m in cell_metrics(bench, "per_layer", cell["name"]):
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(bench, "end_to_end", cell["name"])}
    checks = {name: {"value": v, "limit": limits[name]} for name, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dinfo = device_info(dev, cell["chips"])
    dinfo["memory_peak_bytes"] = out["memory_peak_bytes"]
    if args.trace and "busy_s" in ctx:
        dinfo["busy_s"] = ctx["busy_s"]
        dinfo["window_s"] = ctx["window_s"]
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": dinfo}
    if args.trace and "breakdown" in ctx:
        line["breakdown"] = ctx["breakdown"]
    line["info"] = info
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
