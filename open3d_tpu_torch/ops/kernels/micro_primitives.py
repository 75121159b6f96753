"""Primitive probes: the cost of one instance of each operation that the
integrate and march kernels are built from, on the card (port of
scripts/perf_micro.py).

Each probe computes out = sum_{i < iters} body(i, inputs), accumulated in
out's dtype from zeros with i in order, where body applies one operation
(an elementwise multiply, a relayout, a row gather, a row reduction, a
one-hot build or a matrix product) to its inputs with the loop index folded
in, as the script's bodies do. The time of one instance is the slope
between two repeat counts, (t(9000) - t(1000)) / 8000, the median of five
such slopes taken in one process (`slope_ns`, which also returns their
spread).

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
  products (`product`): bfloat16 x bfloat16 -> float32 on the tensor cores
    (wgmma.mma_async, one warpgroup a 64 x 80 or 64 x 32 tile, A from
    registers), and float32 x float32 with fmaf (not TF32), register-blocked
    4 x 8 x 8 a thread with K split across threads and CTAs.
Bound: operations. Each instance's `+ i`, its accumulate and the operation
itself, over the float32 rate (the bfloat16 tensor rate for the bfloat16
products); the inputs stay in shared memory or registers across the
iterations, so device memory is read once a launch and is not what the
slope measures.

Rounding: the elementwise, relayout, gather and one-hot probes are exact
against the script's kernel run interpreted on the CPU. The plain row sums
take the kernels' order, so on the card they agree with the kernels bit for
bit: the mask-multiply a warp's butterfly each iteration; the segment and
sublane sums partials kept across the iterations (a lane's or a row's),
added across lanes or rows once after the loop. Against XLA's order, and
in the products, the sums differ in the last bits (`tolerance`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from open3d_tpu_torch.ops.kernels import _build
from open3d_tpu_torch.ops.kernels._plain import check_aligned, check_tensor as _check

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

# The product kernels' tiles (csrc/micro_primitives.cu): the bfloat16 product
# takes 64-row tiles (one warpgroup's wgmma) of depth 128 (its A fragments
# stay in registers), 80 columns wide where N allows, else 32; the float32
# product 4 x 8 tiles of out, K in parts of 1024 (a CTA's 128 chunks of 8)
MMA_ROWS, MMA_K, MMA_WIDE, MMA_NARROW = 64, 128, 80, 32
FFMA_ROWS, FFMA_COLS, FFMA_K_CTA = 4, 8, 1024
_PRODUCTS = ("mma_bf16", "ffma")

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
    """The sum an xor butterfly leaves in lane 0, over the last axis of n
    lane values (n a power of 2; 32 for a warp): lane l adds lane l ^ n/2,
    then l ^ n/4, ... l ^ 1."""
    half = v.shape[-1] // 2
    while half >= 1:
        v = v[..., :half] + v[..., half:2 * half]
        half //= 2
    return v[..., 0]


def _partials(probe: Probe, inputs: list, i: int) -> torch.Tensor:
    """The segment and sublane sums' per-thread terms of iteration i, which
    the kernels add into partials kept across the iterations. Segment: lane
    l's sum ((v0 + v1) + v2) + v3 of its four values x[r][128 p + l + 32 q]
    + i, shape (rows, 5, 32). Sublane: x[128 a + 16 g + j][c] + i, one
    partial a row, shape (16 slabs, 8 row groups, 16 rows, 128 columns)."""
    x = inputs[0]
    if probe.kind == "segment":
        y = (x + float(i)).reshape(x.shape[0], -1, 4, 32)
        return ((y[:, :, 0] + y[:, :, 1]) + y[:, :, 2]) + y[:, :, 3]
    return (x + float(i)).reshape(x.shape[0] // 128, 8, 16, x.shape[1])


def _finish(probe: Probe, part: torch.Tensor) -> torch.Tensor:
    """The kernels' sums after the loop. Segment: the warp's butterfly over
    the 32 lane partials. Sublane: a thread adds its 16 row partials in
    order, then three xor shuffles add the 8 row groups."""
    if probe.kind == "segment":
        return _warp_sum(part)
    t = part[:, :, 0]
    for j in range(1, part.shape[2]):
        t = t + part[:, :, j]
    return _warp_sum(t.transpose(1, 2))


def _product_plain(family: str, a: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """sum_{i < iters} (a + i) @ b in float32, from zeros with i in order.
    For bfloat16 a and b: bf16(i) first, then a bf16 + bf16 add rounded
    once, as the body's `ins[0][:] + i.astype(bf16)`; the product in full
    float32. The products' one plain sum: `product` runs it on CPU tensors
    and `probe_plain` holds the kernels to it."""
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=F32, device=a.device)
    for i in range(iters):
        if family == "mma_bf16":
            i_bf = torch.tensor(float(i), device=a.device).to(BF16)
            acc = acc + torch.matmul((a + i_bf).to(F32), b.to(F32))
        else:
            acc = acc + torch.matmul(a + float(i), b)
    return acc


def body_plain(probe: Probe, inputs: list, i: int) -> torch.Tensor:
    """One instance of the probe's body at loop index i, as perf_micro.py's
    lambda computes it (the products' sum is _product_plain)."""
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
    if probe.kind in ("segment", "sublane"):
        return _finish(probe, _partials(probe, inputs, i))
    if probe.kind == "onehot":
        lanes = torch.arange(probe.out_shape[1], device=x.device, dtype=I32)
        return (lanes[None, :] == (x + i)).to(BF16)
    raise ValueError(f"unknown probe {probe.name}")


def probe_plain(probe: Probe, inputs: list, iters: int) -> torch.Tensor:
    """sum_{i < iters} body(i, inputs), accumulated in the output's dtype
    from zeros with i in order; the segment and sublane sums add each
    thread's terms over i first and across threads after, as their kernels
    do. On the card the float32 products need TF32 off
    (torch.backends.cuda.matmul.allow_tf32 = False, the default)."""
    if probe.family in _PRODUCTS:
        return _product_plain(probe.family, inputs[0], inputs[1], iters)
    if probe.kind in ("segment", "sublane"):
        part = torch.zeros_like(_partials(probe, inputs, 0))
        for i in range(iters):
            part = part + _partials(probe, inputs, i)
        return _finish(probe, part)
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


def _check_product_shape(family: str, M: int, K: int, N: int) -> None:
    """Raise ValueError unless the product kernel of `family` takes an
    (M, K) @ (K, N) product: the bfloat16 kernel M a multiple of 64, K =
    128 and N a multiple of 80 or of 32; the float32 kernel M a multiple of
    4, N of 8 and K of 1024."""
    if family == "mma_bf16":
        ok = M > 0 and M % MMA_ROWS == 0 and K == MMA_K and N > 0 and (
            N % MMA_WIDE == 0 or N % MMA_NARROW == 0)
        need = f"M % {MMA_ROWS} == 0, K == {MMA_K}, N % {MMA_WIDE} == 0 or N % {MMA_NARROW} == 0"
    elif family == "ffma":
        ok = min(M, K, N) > 0 and M % FFMA_ROWS == 0 and N % FFMA_COLS == 0 and K % FFMA_K_CTA == 0
        need = f"M % {FFMA_ROWS} == 0, N % {FFMA_COLS} == 0, K % {FFMA_K_CTA} == 0"
    else:
        raise ValueError(f"not a product family: {family}")
    if not ok:
        raise ValueError(f"{family} product ({M}, {K}) @ ({K}, {N}): the kernel's tiles need {need}")


def product(family: str, a: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """sum_{i < iters} (a + i) @ b in float32: bfloat16 a and b with a + bf16(i)
    rounded to bfloat16 ("mma_bf16"), or float32 ("ffma"). Refuses shapes
    the kernel's tiles do not take (_check_product_shape), and bases off
    the kernel's word size, on every device.
    CUDA tensors launch the kernel (the float32 one with its second launch
    over a (K / 1024, M, N) scratch); CPU tensors run the plain sum."""
    dtype = BF16 if family == "mma_bf16" else F32
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{family}: a (M, K) and b (K, N), got {tuple(a.shape)}, {tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    _check_product_shape(family, M, K, N)
    _check(f"{family} a", a, dtype, a.device, (M, K))
    _check(f"{family} b", b, dtype, a.device, (K, N))
    # the float32 kernel reads a and b as 16-byte words, the bfloat16 one a
    # as 4-byte words
    check_aligned(f"{family} a", a, 16 if family == "ffma" else 4)
    if family == "ffma":
        check_aligned(f"{family} b", b)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if a.device.type == "cpu":
        return _product_plain(family, a, b, iters)
    if a.device.type != "cuda":
        raise ValueError(f"{family}: unsupported device {a.device}")

    out = torch.empty((M, N), dtype=F32, device=a.device)
    if family == "mma_bf16":
        _build.launch("o3dt_probe_mma_bf16", a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                      M, K, N, iters)
    else:
        split = torch.empty((K // FFMA_K_CTA, M, N), dtype=F32, device=a.device)
        _build.launch("o3dt_probe_ffma", a.device, a.data_ptr(), b.data_ptr(), split.data_ptr(),
                      out.data_ptr(), M, K, N, iters)
    return out


def occupancy(probe: Probe) -> dict:
    """A product probe's kernel: CTAs a multiprocessor, the card's
    multiprocessors, threads a CTA, registers a thread."""
    if probe.family not in _PRODUCTS:
        raise ValueError(f"{probe.name}: occupancy is reported for the products only")
    return _build.occupancy("o3dt_probe_occupancy", int(probe.family == "ffma"),
                            probe.inputs[1][0][1])


def run_probe(probe: Probe, inputs: list, iters: int) -> torch.Tensor:
    """sum_{i < iters} body(i, inputs) for one of PROBES.

    CUDA tensors launch the kernel of the probe's family (a gather index
    out of [0, 128) stops it with a device fault); CPU tensors run
    probe_plain, after a check that raises on such an index."""
    if probe not in PROBES:
        raise ValueError(f"not one of the probes: {probe}")
    dev = inputs[0].device if inputs else None
    _check_inputs(probe, inputs, dev)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if probe.family in _PRODUCTS:
        return product(probe.family, inputs[0], inputs[1], iters)
    if dev.type == "cpu":
        if probe.family == "gather" and (int(inputs[1].min()) < 0 or int(inputs[1].max()) >= 128):
            raise ValueError(f"{probe.name}: every index must lie in [0, 128)")
        return probe_plain(probe, inputs, iters)
    if dev.type != "cuda":
        raise ValueError(f"run_probe: unsupported device {dev}")

    out = torch.empty(probe.out_shape, dtype=probe.out_dtype, device=dev)
    x = inputs[0]
    if probe.family == "elementwise":
        rows, cols = x.shape
        args = (x.data_ptr(), out.data_ptr(), _EW_CODE[probe.kind], rows, cols, out.numel(), iters)
    elif probe.family == "gather":
        args = (x.data_ptr(), inputs[1].data_ptr(), out.data_ptr(), x.shape[0],
                inputs[1].shape[1], iters)
    elif probe.family == "reduce":
        idx = inputs[1].data_ptr() if len(inputs) > 1 else None
        args = (x.data_ptr(), idx, out.data_ptr(), _RED_CODE[probe.kind], x.shape[0], x.shape[1],
                iters)
    else:
        args = (x.data_ptr(), out.data_ptr(), x.shape[0], probe.out_shape[1], iters)
    _build.launch(f"o3dt_probe_{probe.family}", dev, *args)
    return out


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


def slope_ns(probe: Probe, inputs: list, reps: int = 3) -> tuple:
    """(ns of one instance, spread): the median over _timing.N_READINGS independent
    slopes (t(ITERS_HI) - t(ITERS_LO)) / (ITERS_HI - ITERS_LO), each time
    by CUDA events over `reps` launches (so the launch and the staging
    cancel, as the script's _time_kernel cancels its dispatch), and the
    largest less the smallest of those slopes, in ns."""
    from open3d_tpu_torch.ops.kernels._timing import device_ms, median_of

    def slope():
        t_lo = device_ms(lambda: run_probe(probe, inputs, ITERS_LO), reps)
        t_hi = device_ms(lambda: run_probe(probe, inputs, ITERS_HI), reps)
        return (t_hi - t_lo) / (ITERS_HI - ITERS_LO) * 1e6

    return median_of(slope)


def main() -> None:
    from open3d_tpu_torch.ops.kernels._timing import require_cuda

    dev = require_cuda()
    gen = torch.Generator(device=dev).manual_seed(0)
    for probe in PROBES:
        ns, spread = slope_ns(probe, make_inputs(probe, gen, dev))
        print(f"{probe.name:42s} {ns:9.1f} ns (spread {spread:.1f})", flush=True)


if __name__ == "__main__":
    main()
