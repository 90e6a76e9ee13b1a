"""The roofline probes P1-P4 of the torch port (ops/kernels/vpu_peak.py and
dtype_rate.py, and the tools cs397raytracingsp22_tpu_torch/tools/
vpu_peak*.py and profile_split.py) against the JAX tools' Pallas kernels.

The JAX tools measure when they are imported (tools/vpu_peak_shape.py,
tools/vpu_peak_smem.py) and P4's kernel is nested in main, so `load_tool`
execs only a tool's imports of jax and numpy, its constants and the named
functions. Each JAX kernel runs with pl.pallas_call(..., interpret=True)
on one (64, 128) block (P4: one (8, 128) block), from numpy inputs made
from a seed.

Tolerances, and what was measured on the CPU:
- i32: bit-exact (integer arithmetic).
- f32: rtol 1e-6. XLA's CPU backend contracts the JAX kernels' `v*v + c`
  into one FMA, as the CUDA kernel does, and the plain versions fuse it
  the same way (vpu_peak.fma_f32): the fma chains came out bit-identical
  at unroll 4 and within 6.4e-8 at 12, where the chains have grown to
  ~1e28; the mul chains within 2.5e-7 (XLA also fuses the last squaring
  into the sum, the plain version does not), and XLA flushes subnormal
  results to 0, so f32 chains also get an atol of 8 times the smallest
  normal float32.
- bf16: 1 bf16 ulp; measured bit-identical (XLA rounds each bf16
  operation, as the plain version does).
The `gpu`-marked tests hold each kernel to its plain version on the card
and skip without one, with chip_smoke.py's tolerances: chains rtol 1e-3
up to unroll 12 (and the inf/0 pattern beyond), integers bit-exact; P4
rtol 1e-6 in f32 and within 8 ulps in bf16, whose fused rounds (one
rounding a multiply-add, where the plain version rounds each operation)
an emulation on the CPU put at up to 4 ulps.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cs397raytracingsp22_tpu_torch.ops.kernels import dtype_rate, vpu_peak
from cs397raytracingsp22_tpu_torch.tools import profile_split
from cs397raytracingsp22_tpu_torch.tools import vpu_peak as vpu_peak_tool
from cs397raytracingsp22_tpu_torch.tools import vpu_peak_shape, vpu_peak_smem

torch.set_num_threads(1)  # several test workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = (64, 128)


def load_tool(name: str, defs, nested_in: str | None = None) -> dict:
    """tools/<name>.py's imports of jax and numpy, its constants (assignments
    without calls) and the functions named in `defs` (those defined inside
    `nested_in` too), exec'd into a fresh namespace: the tool's kernels
    without its measurement."""
    path = os.path.join(ROOT, "tools", f"{name}.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    keep = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = [node.module] if isinstance(node, ast.ImportFrom) else [a.name for a in node.names]
            if all(m.split(".")[0] in ("jax", "numpy") for m in mods):
                keep.append(node)
        elif isinstance(node, ast.Assign) and not any(isinstance(n, ast.Call)
                                                      for n in ast.walk(node.value)):
            keep.append(node)
        elif isinstance(node, ast.FunctionDef) and node.name in defs:
            keep.append(node)
        elif isinstance(node, ast.FunctionDef) and node.name == nested_in:
            keep += [n for n in node.body if isinstance(n, ast.FunctionDef) and n.name in defs]
    ns: dict = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    missing = set(defs) - set(ns)
    assert not missing, f"{path} has no {missing}"
    return ns


def run_block(kernel, *args, shape=BLOCK, dtype=jnp.float32, in_specs=None):
    """kernel over one block in interpret mode; returns numpy."""
    spec = pl.BlockSpec(shape, lambda i: (i, 0))
    f = pl.pallas_call(kernel, grid=(1,), in_specs=in_specs or [spec] * len(args),
                       out_specs=spec, out_shape=jax.ShapeDtypeStruct(shape, dtype),
                       interpret=True)
    return np.asarray(f(*args).astype(jnp.float32))


def chain_input(mix: str, shape=BLOCK, seed: int = 0) -> np.ndarray:
    """x for a mix: [-0.3, 0.3] keeps the f32 chains finite for 12 steps;
    the i32 mix starts from x truncated to int32, so it gets a wide range."""
    rng = np.random.default_rng(seed)
    span = 5000.0 if mix == "i32" else 0.3
    return rng.uniform(-span, span, shape).astype(np.float32)


def assert_chain_close(out: np.ndarray, ref: np.ndarray, mix: str, rtol: float) -> None:
    """i32 bit-exact; f32 within rtol, or within 8 times the smallest normal
    float32 where XLA flushed the 8 chains' subnormal results to 0 (the mul
    chains from |x| below ~0.005 reach that range in 4 squarings)."""
    if mix == "i32":
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=rtol, atol=8 * np.finfo(np.float32).tiny)


@pytest.fixture(scope="module")
def p1():
    return load_tool("vpu_peak", {"make_kernel"})


@pytest.mark.parametrize("unroll", [4, 12])
@pytest.mark.parametrize("mix", vpu_peak.MIXES)
def test_chain_plain_matches_jax_vpu_peak(p1, mix, unroll):
    x = chain_input(mix)
    ref = run_block(p1["make_kernel"](unroll, mix), jnp.asarray(x))
    out = vpu_peak.chain_plain(torch.from_numpy(x), mix, unroll).numpy()
    assert np.isfinite(ref).all()
    assert_chain_close(out, ref, mix, rtol=1e-6)


@pytest.mark.parametrize("u,steps", [(2, 3), (1, 5)])
def test_looped_plain_matches_jax_vpu_peak_shape(u, steps):
    ns = load_tool("vpu_peak_shape", {"make_kernel"})
    x = chain_input("fma", seed=1)
    ref = run_block(ns["make_kernel"](u, steps), jnp.asarray(x))
    out = vpu_peak.looped_plain(torch.from_numpy(x), u, steps).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
    # P2's loop and P1's straight line compute the same function
    np.testing.assert_array_equal(out, vpu_peak.chain_plain(torch.from_numpy(x), "fma",
                                                            u * steps).numpy())


@pytest.mark.parametrize("with_loads", [False, True])
def test_table_plain_matches_jax_vpu_peak_smem(with_loads):
    from jax.experimental.pallas import tpu as pltpu

    ns = load_tool("vpu_peak_smem", {"make_kernel"})
    ns["STEPS"] = 8
    x = chain_input("fma", seed=2)
    coefs = np.random.default_rng(0).random(8 * 8, dtype=np.float32)
    spec = pl.BlockSpec(BLOCK, lambda i: (i, 0))
    ref = run_block(ns["make_kernel"](with_loads), jnp.asarray(x), jnp.asarray(coefs),
                    in_specs=[spec, pl.BlockSpec(memory_space=pltpu.SMEM)])
    out = vpu_peak.table_plain(torch.from_numpy(x), torch.from_numpy(coefs) if with_loads
                               else None, 8).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dtype_rate_plain_matches_jax_profile_split(dtype):
    ns = load_tool("profile_split", {"make_k"}, nested_in="main")
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = np.random.default_rng(3).uniform(0.5, 0.9, (8, 128)).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)
    f = pl.pallas_call(ns["make_k"](jdt, iters=8), out_shape=jax.ShapeDtypeStruct((8, 128), jdt),
                       interpret=True)
    ref = np.asarray(f(xj).astype(jnp.float32))
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(tdt)
    out = dtype_rate.dtype_rate_plain(xt, 8).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
    else:
        assert max_ulps(torch.from_numpy(out), torch.from_numpy(ref)) <= 1


def max_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| in bf16 units in the last place of the larger value."""
    a, b = a.float(), b.float()
    e = torch.floor(torch.log2(torch.maximum(a.abs(), b.abs()).clamp(min=1e-30)))
    return float(((a - b).abs() / 2.0 ** (e - 7)).max())


def test_cpu_wrappers_run_the_plain_versions():
    x = torch.from_numpy(chain_input("fma", shape=(4, 128)))
    assert torch.equal(vpu_peak.chain_cuda(x, "both", 4), vpu_peak.chain_plain(x, "both", 4))
    assert torch.equal(vpu_peak.looped_cuda(x, 2, 3), vpu_peak.looped_plain(x, 2, 3))
    coefs = vpu_peak_smem.coefficients("cpu")
    assert torch.equal(vpu_peak.table_cuda(x, coefs, 4, "shared"),
                       vpu_peak.table_plain(x, coefs, 4))
    assert torch.equal(vpu_peak.table_cuda(x, coefs, 4, "const"),
                       vpu_peak.table_plain(x, None, 4))
    xb = x.abs().to(torch.bfloat16) + 0.5
    assert torch.equal(dtype_rate.dtype_rate_cuda(xb, 5), dtype_rate.dtype_rate_plain(xb, 5))
    assert vpu_peak.LAUNCHES == 0 and dtype_rate.LAUNCHES == 0


def test_variants_cover_the_tools():
    for mix in vpu_peak.MIXES:
        for unroll in (256, 1024):
            assert (mix, unroll, "const") in vpu_peak.VARIANTS
    for u, _ in vpu_peak_shape.PAIRS:
        assert ("fma", u, "const") in vpu_peak.VARIANTS
    for memory in vpu_peak_smem.MEMORIES:
        assert ("fma", 1, memory) in vpu_peak.VARIANTS
    assert vpu_peak_smem.STEPS * vpu_peak.CHAINS == vpu_peak.TABLE
    assert vpu_peak_tool.lane_ops("both", 4, 10) == 10 * 12 * 4


def test_tools_run_on_cpu_at_a_tiny_size(capsys):
    wall, ops = vpu_peak_tool.run("i32", 4, reps=1, device="cpu", n_rows=2)
    assert wall > 0 and ops == 2 * 128 * 16 * 4
    rate, (w1, o1), (w2, o2) = vpu_peak_tool.marginal("fma", 48, reps=1, device="cpu", n_rows=2)
    assert o2 == 4 * o1 and rate == (o2 - o1) / (w2 - w1)
    vpu_peak_shape.run(8, 2, reps=1, device="cpu", n_rows=2)
    for memory in ("const",) + vpu_peak_smem.MEMORIES:
        vpu_peak_smem.run(memory, reps=1, device="cpu", n_rows=2, steps=4)
    out = profile_split.run(device="cpu", width=4, spp=1, sort_sizes=(512,), p4_rows=(8,),
                            p4_iters=4)
    assert set(out["split"]) == {name for name, _, _ in profile_split.SPLITS}
    assert out["split"]["no-teapot depth8"][1] > 0 and len(out["sort"]) == 3
    text = capsys.readouterr().out
    for line in ("fma  unroll=   12", "fma  marginal issue rate", "body=   64 FMAs x    2 iters",
                 "fma+constant-load", "== scene/depth split ==", "sort n=0M vals=14",
                 "argsort+take n=0M vals=14", "bfloat16 (8, 128)"):
        assert line in text


def test_no_teapot_split_drops_the_mesh():
    import dataclasses

    from cs397raytracingsp22_tpu_torch import StaticMesh
    from cs397raytracingsp22_tpu_torch.scenes import bench_scene

    sc = bench_scene.build(4, 4, spp=1, path_depth=1)
    kept = [o for o in sc.objects if not isinstance(o, StaticMesh)]
    data = dataclasses.replace(sc, objects=kept).compile(device="cpu")
    assert len(kept) == len(sc.objects) - 1 and not data.meshes


def test_tools_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vpu_peak_tool.run("fma", 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vpu_peak_smem.main()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mix", vpu_peak.MIXES)
def test_chain_kernel_matches_plain_on_card(cuda, mix):
    x = torch.from_numpy(chain_input(mix, shape=(1024, 128), seed=4)).to(cuda)
    for unroll in (4, 12):
        before = vpu_peak.LAUNCHES
        out = vpu_peak.chain_cuda(x, mix, unroll)
        torch.cuda.synchronize()
        assert vpu_peak.LAUNCHES == before + 1
        ref = vpu_peak.chain_plain(x, mix, unroll)
        assert_chain_close(out.cpu().numpy(), ref.cpu().numpy(), mix, rtol=1e-3)
    # beyond ~13 steps the f32 chains overflow (fma) or vanish (mul)
    out = vpu_peak.chain_cuda(torch.full((64, 128), 0.3, device=cuda), mix, 256)
    ref = vpu_peak.chain_plain(torch.full((64, 128), 0.3, device=cuda), mix, 256)
    assert torch.equal(torch.isinf(out), torch.isinf(ref)) and torch.equal(out == 0, ref == 0)
    if mix == "i32":
        assert torch.equal(out, ref)
    with pytest.raises(ValueError, match="built for unroll"):
        vpu_peak.chain_cuda(x, mix, 16)


@pytest.mark.gpu
def test_looped_and_table_kernels_match_plain_on_card(cuda):
    x = torch.from_numpy(chain_input("fma", shape=(1024, 128), seed=5)).to(cuda)
    for u, steps in ((2, 3), (1, 5), (8, 1)):
        out = vpu_peak.looped_cuda(x, u, steps)
        np.testing.assert_allclose(out.cpu().numpy(),
                                   vpu_peak.looped_plain(x, u, steps).cpu().numpy(), rtol=1e-3)
    coefs = vpu_peak_smem.coefficients(cuda)
    ref = vpu_peak.table_plain(x, coefs, 8)
    for memory in vpu_peak_smem.MEMORIES:
        before = vpu_peak.LAUNCHES
        out = vpu_peak.table_cuda(x, coefs, 8, memory)
        torch.cuda.synchronize()
        assert vpu_peak.LAUNCHES == before + 1
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=1e-3)
    with pytest.raises(ValueError, match="exceed"):
        vpu_peak.table_cuda(x, coefs, 513, "shared")
    with pytest.raises(ValueError, match="no chain"):
        vpu_peak.looped_cuda(x, 3, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dtype_rate_kernel_matches_plain_on_card(cuda, dtype):
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(np.random.default_rng(6).uniform(0.5, 0.9, (512, 128))
                         .astype(np.float32)).to(cuda, tdt)
    for iters in (8, 2000):
        before = dtype_rate.LAUNCHES
        out = dtype_rate.dtype_rate_cuda(x, iters)
        torch.cuda.synchronize()
        assert dtype_rate.LAUNCHES == before + 1
        ref = dtype_rate.dtype_rate_plain(x, iters)
        assert bool(torch.isfinite(out.float()).all())
        if dtype == "float32":
            np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=1e-6)
        else:
            assert max_ulps(out.cpu(), ref.cpu()) <= 8
    with pytest.raises(ValueError, match="even"):
        dtype_rate.dtype_rate_cuda(torch.ones((3,), dtype=torch.bfloat16, device=cuda), 4)
