"""Port parity for the three probe kernels ported from scripts/: the plain
versions that the port runs on the CPU (the wrappers take them for CPU
tensors) against the scripts' own Pallas kernels, run interpreted on the
CPU, on the same numpy inputs.

The scripts run their probes when they are imported, so each is loaded by
parsing it and keeping only its imports, its functions and the constants a
test needs; its `pl` is swapped for a copy whose pallas_call adds
`interpret=True`. No file under scripts/ is edited.

Bars: the gather (P2) and the march (P3) are bit-exact. Of the primitive
probes (P1, at iters = 3 and the script's full shapes), the elementwise,
relayout, gather and one-hot probes are exact; the row reductions and
products sum in another order than XLA's and agree within
`micro_primitives.tolerance` (1e-5 of the largest output; 1e-4 for the
bfloat16 products, whose bar is set by the card's tensor cores).
"""

import ast
import contextlib
import io
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from open3d_tpu_torch.ops.kernels import micro_gather as p2
from open3d_tpu_torch.ops.kernels import micro_primitives as p1
from open3d_tpu_torch.ops.kernels import micro_raymarch as p3

torch.set_num_threads(2)
SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"


def _load_script(name: str, keep=()) -> dict:
    """The script's imports, functions and the module-level constants named
    in `keep`, executed into a namespace whose pallas_call interprets."""
    path = SCRIPTS / name
    tree = ast.parse(path.read_text(), filename=str(path))
    body = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom, ast.FunctionDef)):
            body.append(node)
        elif isinstance(node, ast.Assign):
            names = {n.id for t in node.targets for n in ast.walk(t) if isinstance(n, ast.Name)}
            if names <= set(keep):
                body.append(node)
    tree.body = body
    ns = {"__name__": f"script_{path.stem}"}
    exec(compile(tree, str(path), "exec"), ns)
    shim = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")})
    shim.pallas_call = lambda *a, **kw: pl.pallas_call(*a, interpret=True, **kw)
    ns["pl"] = shim
    return ns


def _t(a: np.ndarray) -> torch.Tensor:
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


# ---- P3: the staged-block march ------------------------------------------


def test_raymarch_constants_match_the_script():
    ns = _load_script("micro_raymarch_kernel.py", keep=("T", "K", "M", "NR", "C"))
    assert (ns["T"], ns["K"], ns["M"], ns["NR"], ns["C"]) == (p3.T, p3.K, p3.M, p3.NR, p3.C)


def test_raymarch_plain_matches_interpreted_kernel():
    ns = _load_script("micro_raymarch_kernel.py", keep=("T", "K", "M", "NR", "C"))
    T, C = 4, 64
    ns["T"], ns["C"] = T, C
    rng = np.random.default_rng(3)
    tw = rng.integers(-(2**31), 2**31 - 1, (C, 32, 128), dtype=np.int64).astype(np.int32)
    tw[5, :, :64] &= ~0xFFFF  # unallocated voxels read 2.0
    rows = rng.integers(0, C, (T, p3.K)).astype(np.int32)
    ref = np.asarray(ns["f"](jnp.asarray(rows), jnp.asarray(tw)))
    out = p3.march(_t(rows), _t(tw))  # CPU tensors: the plain version
    assert out.shape == (T, 1, p3.NR) and out.dtype == torch.float32
    par = p3.parity(out, _t(ref))
    assert par["hit_agree"] == 1.0 and par["hit_frac"] > 0.5, par
    np.testing.assert_array_equal(out.numpy(), ref)


# ---- P2: the gather ------------------------------------------------------


@pytest.mark.parametrize("variant", ["take", "reduce"])
@pytest.mark.parametrize("R", [32, 320])
def test_gather_plain_matches_interpreted_kernel(R, variant):
    ns = _load_script("micro_onehot_gather.py")
    s_chunk, n_chunks = 256, 4
    rng = np.random.default_rng(R)
    table = rng.standard_normal((R, 128)).astype(np.float32)
    idx = rng.integers(0, R * 128, (s_chunk * n_chunks, 1)).astype(np.int32)
    ref = np.asarray(ns["make_gather"](R, s_chunk, n_chunks, variant)(jnp.asarray(table),
                                                                       jnp.asarray(idx)))
    out = p2.gather(_t(table), _t(idx))  # CPU tensors: the plain version
    assert out.shape == idx.shape and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy().ravel(), table.ravel()[idx.ravel()])


def test_gather_sizes_are_the_scripts():
    assert p2.NS == 12_000_000
    assert [p2.n_indices(s) for _, s in p2.CONFIGS] == [11_999_232, 11_999_232, 11_993_088]
    assert p2.bytes_moved(32, p2.n_indices(2048)) == 96_010_240


# ---- P1: the primitive probes --------------------------------------------


@pytest.fixture(scope="module")
def probes():
    """Each of perf_micro.main's 17 probes: its label, the script's inputs
    as numpy arrays, and the output of its kernel built by the script's
    _run_one at iters = 3, interpreted."""
    ns = _load_script("perf_micro.py", keep=("ITERS_LO", "ITERS_HI"))
    recorded = []

    def record(body, inputs, out_shape, n_calls=5, scratch_shapes=()):
        recorded.append((body, inputs, out_shape, scratch_shapes))
        return 0.0

    ns["_time_kernel"] = record
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        ns["main"]()
    names = [line.rsplit(None, 2)[0].strip() for line in printed.getvalue().splitlines()]
    assert len(names) == len(recorded)

    outputs = []
    interpret = ns["pl"].pallas_call

    def pallas_call(*a, **kw):
        f = interpret(*a, **kw)

        def run(*args):
            out = f(*args)
            outputs.append(out)
            return out

        return run

    ns["pl"].pallas_call = pallas_call
    ns["jax"] = types.SimpleNamespace(jit=lambda f: f, lax=jax.lax, random=jax.random, numpy=jnp)
    got = {}
    for name, (body, inputs, out_shape, scratch) in zip(names, recorded):
        ns["_run_one"](body, inputs, out_shape, 3, 1, scratch)
        got[name] = ([np.asarray(x) for x in inputs], np.asarray(outputs[-1]))
    return names, got


def test_probe_list_matches_the_script(probes):
    names, got = probes
    assert names == [p.name for p in p1.PROBES]
    for p in p1.PROBES:
        ins, out = got[p.name]
        assert [(tuple(x.shape), _t(x).dtype) for x in ins] == [(s, d) for s, d, _ in p.inputs]
        assert tuple(out.shape) == p.out_shape and _t(out).dtype == p.out_dtype
    assert (p1.ITERS_LO, p1.ITERS_HI) == (1000, 9000)


@pytest.mark.parametrize("name", [p.name for p in p1.PROBES])
def test_probe_plain_matches_interpreted_kernel(probes, name):
    probe = p1.BY_NAME[name]
    ins, ref = probes[1][name]
    out = p1.run_probe(probe, [_t(x) for x in ins], 3)  # CPU tensors: the plain version
    ref = _t(ref)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    tol = p1.tolerance(probe)
    if tol == 0.0:
        assert torch.equal(out, ref)
    else:
        assert p1.rel_err(out, ref) <= tol


def test_probe_ops_counts():
    by = p1.BY_NAME
    assert p1.instance_ops(by["mul (2048,128) f32"]) == 1 + 2 * 2048 * 128
    assert p1.instance_ops(by["matmul f32 (16,2048)@(2048,640)"]) == (
        16 * 2048 + 2 * 16 * 2048 * 640 + 16 * 640)
    assert p1.instance_ops(by["segreduce 5x(2048,128)->(2048,5)"]) == 2048 * 640 * 2 + 2048 * 5
    # a gather adds i to the gathered values only; the mask-multiply's lane
    # sum is that gather; the broadcast's * 1.0 is free
    assert p1.instance_ops(by["take_along_axis (2048,128)"]) == 2 * 2048 * 128
    assert p1.instance_ops(by["take_along 1col (2048,128)"]) == 2 * 2048
    assert p1.instance_ops(by["maskmul+lanereduce (2048,128)"]) == 2 * 2048
    assert p1.instance_ops(by["bcast lane->sub (32,128)->(32,128,128)"]) == 32 * 128 + 32 * 128 * 128


@pytest.mark.parametrize("name", ["segreduce 5x(2048,128)->(2048,5)",
                                  "reshape3d+subreduce (2048,128)"])
def test_reduction_twins_take_the_kernels_order(name):
    """The segment and sublane plain versions add in the order their
    kernels do (csrc/micro_primitives.cu), modelled here thread by thread in
    numpy float32: each thread's partials run over the iterations first,
    then the lanes or row groups are added by the xor butterfly. On the
    card that order is what makes the kernels bit-exact with the plain
    versions."""
    probe = p1.BY_NAME[name]
    x = np.random.default_rng(9).standard_normal(probe.inputs[0][0]).astype(np.float32)
    iters = 4

    def butterfly(v):  # lane 0 of an xor butterfly over the last axis
        while v.shape[-1] > 1:
            h = v.shape[-1] // 2
            v = v[..., :h] + v[..., h:]
        return v[..., 0]

    if probe.kind == "segment":
        # lane l of row r: four values x[r][128 p + l + 32 q] a segment p
        v = x.reshape(x.shape[0], 5, 4, 32)
        acc = np.zeros((x.shape[0], 5, 32), np.float32)
        for i in range(iters):
            fi = np.float32(i)
            acc = acc + ((((v[:, :, 0] + fi) + (v[:, :, 1] + fi)) + (v[:, :, 2] + fi))
                         + (v[:, :, 3] + fi))
        expect = butterfly(acc)
    else:
        # thread (slab a, group g, column c): rows 128 a + 16 g + j, j < 16
        v = x.reshape(16, 8, 16, 128)
        part = np.zeros_like(v)
        for i in range(iters):
            part = part + (v + np.float32(i))
        t = part[:, :, 0]
        for j in range(1, 16):
            t = t + part[:, :, j]
        expect = butterfly(np.moveaxis(t, 1, 2))
    out = p1.run_probe(probe, [_t(x)], iters)  # CPU tensors: the plain version
    np.testing.assert_array_equal(out.numpy(), expect)
