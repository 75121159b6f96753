"""The benchmark of the PyTorch/CUDA port (`open3d_tpu_torch`) on one H100.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` at the root names the cells, the metrics and the bounds.
Everything one configuration, traffic mix, per-layer metric or kernel count
needs sits in a file of its own under this folder, found by that name:
`configs/<config>.json`, `traffic/<mix>.json` (whose `driver` names
`drivers/<driver>.py`), `metrics/<metric>.py` and `counts/<kernel>.py`.
`reference/` is the plain PyTorch reference that decides `correct`;
`frames.py` the frozen scene and renderer. Nothing here imports JAX or the
JAX package.
"""
