"""Primitive probes: the cost of one instance of each operation that the
integrate and march kernels are built from, on the card (port of
scripts/perf_micro.py).

Each probe computes out = sum_{i < iters} body(i, inputs), accumulated in
out's dtype from zeros with i in order, where body applies one operation
(an elementwise multiply, a relayout, a row gather, a row reduction, a
one-hot build or a matrix product) to its inputs with the loop index folded
in, as the script's bodies do. The time of one instance is the slope
between two repeat counts, (t(9000) - t(1000)) / 8000.

`run_probe` launches the CUDA kernel of the probe's family in
`csrc/micro_primitives.cu` for CUDA tensors and runs `probe_plain`, the same
function in plain PyTorch, for CPU tensors. Nothing falls back: a CUDA
tensor either launches the kernel or raises.

Replaces: scripts/perf_micro.py:_run_one (the pallas_call at :39) over the
17 bodies of main (:69-180). One kernel template per family:
  elementwise and relayout: the three multiplies, the reshape, the two
    transposes, the broadcast;
  row gather (torch.gather semantics): the two take_along_axis probes;
  row reductions: mask-multiply + lane sum, 5-segment sum, sublane sum;
  one-hot build (accumulated in bfloat16);
  products: bfloat16 x bfloat16 -> float32 on the tensor cores (mma.sync
    m16n8k16), and float32 x float32 with fmaf (not TF32).
Bound: operations. Each instance's `+ i`, its accumulate and the operation
itself, over the float32 rate (the bfloat16 tensor rate for the bfloat16
products); the inputs stay in shared memory across the iterations, so
device memory is read once a launch and is not what the slope measures.

Rounding: the elementwise, relayout, gather and one-hot probes are exact
against the script's kernel run interpreted on the CPU. The plain row sums
take the kernels' order (lane partials, then the warp's butterfly), so on
the card they agree with the kernels bit for bit; against XLA's order, and
in the products, the sums differ in the last bits (`tolerance`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from open3d_tpu_torch.ops.kernels._plain import check_tensor as _check

ITERS_LO = 1000
ITERS_HI = 9000

F32, BF16, I32 = torch.float32, torch.bfloat16, torch.int32


@dataclass(frozen=True)
class Probe:
    name: str  # the script's own label
    family: str  # elementwise, gather, reduce, onehot, mma_bf16, ffma
    kind: str  # the operation inside the family
    inputs: tuple  # ((shape, dtype, source), ...); source: "normal" or ("randint", hi)
    out_shape: tuple
    out_dtype: torch.dtype


def _n(shape, dtype=F32):
    return (shape, dtype, "normal")


def _r(shape, hi=128):
    return (shape, I32, ("randint", hi))


PROBES: Sequence[Probe] = (
    Probe("mul (2048,1) f32", "elementwise", "mul", (_n((2048, 1)),), (2048, 1), F32),
    Probe("mul (2048,128) f32", "elementwise", "mul", (_n((2048, 128)),), (2048, 128), F32),
    Probe("mul (32,128) f32", "elementwise", "mul", (_n((32, 128)),), (32, 128), F32),
    Probe("take_along_axis (2048,128)", "gather", "full",
          (_n((2048, 128)), _r((2048, 128))), (2048, 128), F32),
    Probe("take_along 1col (2048,128)", "gather", "col",
          (_n((2048, 128)), _r((2048, 1))), (2048, 1), F32),
    Probe("maskmul+lanereduce (2048,128)", "reduce", "maskmul",
          (_n((2048, 128)), _r((2048, 1))), (2048, 1), F32),
    Probe("segreduce 5x(2048,128)->(2048,5)", "reduce", "segment", (_n((2048, 640)),),
          (2048, 5), F32),
    Probe("reshape (2048,1)->(16,128)", "elementwise", "reshape", (_n((2048, 1)),), (16, 128), F32),
    Probe("reshape3d+subreduce (2048,128)", "reduce", "sublane", (_n((2048, 128)),), (16, 128),
          F32),
    Probe("onehot build (2048,128) bf16", "onehot", "onehot", (_r((2048, 1)),), (2048, 128), BF16),
    Probe("matmul bf16 (2048,128)@(128,640)", "mma_bf16", "matmul",
          (_n((2048, 128), BF16), _n((128, 640), BF16)), (2048, 640), F32),
    Probe("matmul f32 (16,2048)@(2048,640)", "ffma", "matmul",
          (_n((16, 2048)), _n((2048, 640))), (16, 640), F32),
    Probe("matmul bf16 (2048,128)@(128,128)", "mma_bf16", "matmul",
          (_n((2048, 128), BF16), _n((128, 128), BF16)), (2048, 128), F32),
    Probe("matmul f32 (16,2048)@(2048,128)", "ffma", "matmul",
          (_n((16, 2048)), _n((2048, 128))), (16, 128), F32),
    Probe("transpose (128,2048)", "elementwise", "transpose", (_n((128, 2048)),), (2048, 128), F32),
    Probe("transpose (2048,8)", "elementwise", "transpose", (_n((2048, 8)),), (8, 2048), F32),
    Probe("bcast lane->sub (32,128)->(32,128,128)", "elementwise", "bcast", (_n((32, 128)),),
          (32, 128, 128), F32),
)
BY_NAME = {p.name: p for p in PROBES}

# Elementwise kinds and their codes in csrc/micro_primitives.cu
_EW_CODE = {"mul": 0, "reshape": 1, "transpose": 2, "bcast": 3}
_RED_CODE = {"maskmul": 0, "segment": 1, "sublane": 2}


def make_inputs(probe: Probe, generator: torch.Generator, device) -> list:
    """The probe's inputs, drawn from `generator` (on `device`) as the
    script draws them: standard normals (rounded to bfloat16 where the
    input is bfloat16) and integers in [0, hi)."""
    out = []
    for shape, dtype, src in probe.inputs:
        if src == "normal":
            x = torch.randn(shape, generator=generator, device=device, dtype=F32).to(dtype)
        else:
            x = torch.randint(0, src[1], shape, generator=generator, device=device, dtype=I32)
        out.append(x.contiguous())
    return out


def _warp_sum(v: torch.Tensor) -> torch.Tensor:
    """The sum a warp's xor butterfly leaves in lane 0, over the last axis
    of 32 lane values: lane l adds lane l ^ 16, then l ^ 8, ... l ^ 1."""
    for half in (16, 8, 4, 2, 1):
        v = v[..., :half] + v[..., half:2 * half]
    return v[..., 0]


def body_plain(probe: Probe, inputs: list, i: int) -> torch.Tensor:
    """One instance of the probe's body at loop index i, as perf_micro.py's
    lambda computes it."""
    x = inputs[0]
    fi = float(i)
    if probe.kind == "mul":
        return x * (1.0 + fi)
    if probe.kind == "reshape":
        return (x + fi).reshape(probe.out_shape)
    if probe.kind == "transpose":
        return (x + fi).t()
    if probe.kind == "bcast":
        return (x + fi)[:, :, None].expand(probe.out_shape) * 1.0
    if probe.family == "gather":
        idx = inputs[1].long()
        return torch.gather(x + fi, 1, idx)
    # The row sums take the kernels' order: a warp a row, each lane summing
    # its four columns l + 32 q in turn, then the xor butterfly of the warp
    if probe.kind == "maskmul":
        lanes = torch.arange(x.shape[1], device=x.device, dtype=I32)
        y = ((x + fi) * (lanes[None, :] == inputs[1]).to(F32)).reshape(-1, 4, 32)
        return _warp_sum(((y[:, 0] + y[:, 1]) + y[:, 2]) + y[:, 3])[:, None]
    if probe.kind == "segment":
        y = (x + fi).reshape(x.shape[0], -1, 4, 32)
        return _warp_sum(((y[:, :, 0] + y[:, :, 1]) + y[:, :, 2]) + y[:, :, 3])
    if probe.kind == "sublane":
        # a thread a column: four running sums over the rows b = 4 t + j
        y = (x + fi).reshape(16, 32, 4, x.shape[1])
        s = y[:, 0]
        for t in range(1, 32):
            s = s + y[:, t]
        return (s[:, 0] + s[:, 1]) + (s[:, 2] + s[:, 3])
    if probe.kind == "onehot":
        lanes = torch.arange(probe.out_shape[1], device=x.device, dtype=I32)
        return (lanes[None, :] == (x + i)).to(BF16)
    if probe.family == "mma_bf16":
        # bf16(i) first, then a bf16 + bf16 add rounded once, as the body's
        # `ins[0][:] + i.astype(bf16)`; the product in full float32
        i_bf = torch.tensor(fi, device=x.device).to(BF16)
        return torch.matmul((x + i_bf).to(F32), inputs[1].to(F32))
    if probe.family == "ffma":
        return torch.matmul(x + fi, inputs[1])
    raise ValueError(f"unknown probe {probe.name}")


def probe_plain(probe: Probe, inputs: list, iters: int) -> torch.Tensor:
    """sum_{i < iters} body(i, inputs), accumulated in the output's dtype
    from zeros with i in order. On the card the float32 products need TF32
    off (torch.backends.cuda.matmul.allow_tf32 = False, the default)."""
    acc = torch.zeros(probe.out_shape, dtype=probe.out_dtype, device=inputs[0].device)
    for i in range(iters):
        acc = acc + body_plain(probe, inputs, i)
    return acc


def instance_ops(probe: Probe) -> int:
    """Arithmetic operations one instance's function needs at the least:
    the `+ i` (or the multiply's 1 + i and product) on the values that
    reach the output, the operation itself, and the accumulate into out.
    A multiply-add counts two; compares count one; relayouts and gathers
    move data and count none beyond the add. Where a cheaper form gives the
    same floats, it is the one counted: a gather adds i to the gathered
    values only, the mask-multiply's lane sum (one value and 127 exact
    zeros) is that gather, and the broadcast's `* 1.0` is the identity."""
    n_out = 1
    for s in probe.out_shape:
        n_out *= s
    n_in = 1
    for s in probe.inputs[0][0]:
        n_in *= s
    if probe.kind == "mul":
        return 1 + 2 * n_out  # 1 + i once; the product and the accumulate
    if probe.family == "gather" or probe.kind == "maskmul":
        return 2 * n_out  # + i on each gathered value; the accumulate
    if probe.family == "elementwise":
        return n_in + n_out  # + i on every input element; the accumulate
    if probe.family == "reduce":
        return n_in * 2 + n_out  # + i and the sum on each element; the accumulate
    if probe.kind == "onehot":
        return n_in + n_out * 2  # idx + i; compare and accumulate each element
    M, K = probe.inputs[0][0]
    N = probe.inputs[1][0][1]
    return M * K + 2 * M * K * N + M * N


def _check_inputs(probe: Probe, inputs: list, dev) -> None:
    if len(inputs) != len(probe.inputs):
        raise ValueError(f"{probe.name}: expected {len(probe.inputs)} inputs, got {len(inputs)}")
    for j, ((shape, dtype, _), x) in enumerate(zip(probe.inputs, inputs)):
        _check(f"{probe.name} input {j}", x, dtype, dev, shape)


def run_probe(probe: Probe, inputs: list, iters: int) -> torch.Tensor:
    """sum_{i < iters} body(i, inputs) for one of PROBES.

    CUDA tensors launch the kernel of the probe's family and count one in
    `run_probe.launches` (a gather index out of [0, 128) stops it with a
    device fault); CPU tensors run probe_plain, after a check that raises
    on such an index."""
    if probe not in PROBES:
        raise ValueError(f"not one of the probes: {probe}")
    dev = inputs[0].device if inputs else None
    _check_inputs(probe, inputs, dev)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if dev.type == "cpu":
        if probe.family == "gather" and (int(inputs[1].min()) < 0 or int(inputs[1].max()) >= 128):
            raise ValueError(f"{probe.name}: every index must lie in [0, 128)")
        return probe_plain(probe, inputs, iters)
    if dev.type != "cuda":
        raise ValueError(f"run_probe: unsupported device {dev}")

    from open3d_tpu_torch.ops.kernels import _build

    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty(probe.out_shape, dtype=probe.out_dtype, device=dev)
    x = inputs[0]
    if probe.family == "elementwise":
        rows, cols = x.shape
        err = lib.o3dt_probe_elementwise(x.data_ptr(), out.data_ptr(), _EW_CODE[probe.kind],
                                         rows, cols, out.numel(), iters, stream)
    elif probe.family == "gather":
        err = lib.o3dt_probe_gather(x.data_ptr(), inputs[1].data_ptr(), out.data_ptr(),
                                    x.shape[0], inputs[1].shape[1], iters, stream)
    elif probe.family == "reduce":
        idx = inputs[1].data_ptr() if len(inputs) > 1 else None
        err = lib.o3dt_probe_reduce(x.data_ptr(), idx, out.data_ptr(), _RED_CODE[probe.kind],
                                    x.shape[0], x.shape[1], iters, stream)
    elif probe.family == "onehot":
        err = lib.o3dt_probe_onehot(x.data_ptr(), out.data_ptr(), x.shape[0], probe.out_shape[1],
                                    iters, stream)
    else:
        M, K = x.shape
        N = inputs[1].shape[1]
        fn = lib.o3dt_probe_mma_bf16 if probe.family == "mma_bf16" else lib.o3dt_probe_ffma
        err = fn(x.data_ptr(), inputs[1].data_ptr(), out.data_ptr(), M, K, N, iters, stream)
    _build.check(err)
    run_probe.launches += 1
    return out


run_probe.launches = 0


def tolerance(probe: Probe) -> float:
    """Largest |kernel - plain| / max |plain| allowed at iters = ITERS_LO.
    0 where both compute the same roundings in the same order. 1e-5 for the
    float32 reductions (whose plain sums take the kernels' order, so they
    agree exactly; the bar is for XLA's order on the CPU) and products,
    which cuBLAS sums in another order. 1e-4 for the bfloat16 products:
    the tensor cores add the 16 exact products of an m16n8k16 step and
    truncate, not round, into their float32 sum, so their error is biased
    and grows with the sum of |products| (about 1e5 an instance at i near
    1000, against a largest output near 1.6e7 after 1000 instances): a
    few parts in 1e5 at worst, against cuBLAS's float32 product of the
    same bfloat16 values."""
    if probe.family in ("elementwise", "gather", "onehot"):
        return 0.0
    return 1e-4 if probe.family == "mma_bf16" else 1e-5


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| / max |ref|, in float32."""
    out, ref = out.float(), ref.float()
    return float((out - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


def slope_ns(probe: Probe, inputs: list, reps: int = 3) -> float:
    """ns of one instance: (t(ITERS_HI) - t(ITERS_LO)) / (ITERS_HI -
    ITERS_LO), each launch time by CUDA events, so the launch and the
    staging cancel, as the script's _time_kernel cancels its dispatch."""
    from open3d_tpu_torch.ops.kernels._timing import device_ms

    t_lo = device_ms(lambda: run_probe(probe, inputs, ITERS_LO), reps)
    t_hi = device_ms(lambda: run_probe(probe, inputs, ITERS_HI), reps)
    return (t_hi - t_lo) / (ITERS_HI - ITERS_LO) * 1e6


def main() -> None:
    from open3d_tpu_torch.ops.kernels._timing import require_cuda

    dev = require_cuda()
    gen = torch.Generator(device=dev).manual_seed(0)
    for probe in PROBES:
        print(f"{probe.name:42s} {slope_ns(probe, make_inputs(probe, gen, dev)):9.1f} ns",
              flush=True)


if __name__ == "__main__":
    main()
