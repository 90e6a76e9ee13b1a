"""The Baldwin–Weber scan probe P5 of the torch port (models/scene.py::
baldwin_weber_rows, ops/kernels/bw_scan.py and tools/bench_mxu_scan.py)
against the JAX package: _baldwin_weber_rows and tools/bench_mxu_scan.py's
scalar_kernel and mxu_kernel, loaded without the tool's measurement
(test_torch_probes.load_tool) and run with pl.pallas_call(...,
interpret=True) on one block of 8,192 rays against 256 triangles.

Tolerances, and what was measured on the CPU:
- baldwin_weber_rows: bit-exact (the same float64 numpy on the host).
- With an exact reciprocal put into the loaded namespace's `pl` (the JAX
  kernels' only difference from the plain versions' arithmetic): the same
  key on >= 99.9% of rays, t within rtol 1e-5 where both hit; measured
  every key equal. XLA's CPU backend fuses the scalar kernel's
  multiply-adds, and bw_scan_plain fuses the same ones; unfused, 3% of the
  keys differed in t's last bits.
- With JAX's own pl.reciprocal(approx=True), which interpret mode rounds
  through bfloat16 (relative error up to 3.9e-3): hits agree on >= 99% of
  rays, and t within rtol 8e-3 where both hit, apart from winner flips (a
  nearer triangle within the reciprocal's error), at most 1% of those
  rays; for the matrix scan, whose key names the winner, t within 8e-3
  wherever both pick the same triangle. Measured 99.87% agreement and 2
  flips of 702 rays that both hit.
The `gpu`-marked tests hold the kernels on the card, with chip_smoke.py's
tolerances: the scalar kernel against bw_scan_plain, the same key once the
low 12 bits are dropped (t to the matrix key's 11 mantissa bits) on >=
99.9% of rays; the mma kernel against bw_mma_plain with TF32 operands, the
same winner on >= 99.9%; the mma kernel against the scalar kernel, hits
agree on >= 99% (the JAX tool's parity line, t's p99 printed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cs397raytracingsp22_tpu.models.scene import _baldwin_weber_rows
from cs397raytracingsp22_tpu_torch.models.scene import baldwin_weber_rows
from cs397raytracingsp22_tpu_torch.ops.kernels import bw_scan
from cs397raytracingsp22_tpu_torch.tools import bench_mxu_scan
# sibling test modules by their bare names (pytest puts tests/ on sys.path)
from test_torch_probes import load_tool

torch.set_num_threads(1)  # several test workers share the cores

N = bench_mxu_scan.N


class ExactReciprocal:
    """The loaded tool's `pl` with pl.reciprocal exact, everything else
    Pallas's own."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def reciprocal(x, approx=False):
        return 1.0 / x


@pytest.fixture(scope="module")
def p5():
    """The JAX tool's kernels, the port tool's scene at one block, and both
    packages' operands."""
    ns = load_tool("bench_mxu_scan", {"_consts", "bci", "scalar_kernel", "mxu_kernel"})
    assert (ns["G"], ns["N"], ns["GSTEP"]) == (bench_mxu_scan.G, N, bw_scan.GROUP)
    a = bench_mxu_scan.inputs("cpu", nblk=1)
    return ns, a


def jax_keys(ns, a, kernel: str, exact: bool) -> np.ndarray:
    ns["pl"] = ExactReciprocal() if exact else pl
    if kernel == "scalar":
        spec = pl.BlockSpec((64, 128), lambda i: (i, 0))
        planes = [jnp.asarray(x.numpy()).reshape(64, 128) for x in (*a["o4"][:3], *a["d4"][:3])]
        f = pl.pallas_call(ns["scalar_kernel"], grid=(1,),
                           in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] + [spec] * 6,
                           out_specs=spec, out_shape=jax.ShapeDtypeStruct((64, 128), jnp.int32),
                           interpret=True)
        return np.asarray(f(jnp.asarray(a["bw"].numpy()), *planes)).reshape(-1)
    ray = pl.BlockSpec((4, N), lambda i: (0, i))
    f = pl.pallas_call(ns["mxu_kernel"], grid=(1,),
                       in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2 + [ray] * 2,
                       out_specs=pl.BlockSpec((1, N), lambda i: (0, i)),
                       out_shape=jax.ShapeDtypeStruct((1, N), jnp.int32), interpret=True)
    args = [jnp.asarray(a[k].numpy()) for k in ("lhs_o", "lhs_d", "o4", "d4")]
    return np.asarray(f(*args)).reshape(-1)


def plain_keys(a, kernel: str) -> np.ndarray:
    if kernel == "scalar":
        return bw_scan.bw_scan_plain(a["bw"], a["o4"], a["d4"]).numpy()
    return bw_scan.bw_mma_plain(a["lhs_o"], a["lhs_d"], a["o4"], a["d4"]).numpy()


def decode(key: np.ndarray, mma: bool):
    hit, t = bw_scan.hit_t(torch.from_numpy(key), mma)
    return hit.numpy(), t.numpy()


def test_baldwin_weber_rows_bit_exact_against_jax():
    rng = np.random.default_rng(0)
    verts = rng.uniform(-2, 2, (300, 3, 3))
    verts[::7, 1] = verts[::7, 0]  # a repeated vertex: zero area
    verts[3::11, 2] = 2 * verts[3::11, 1] - verts[3::11, 0]  # collinear
    verts[5] = 0.0
    ours, ref = baldwin_weber_rows(verts), _baldwin_weber_rows(verts)
    assert ours.dtype == np.float32 and ours.shape == (300, 12)
    np.testing.assert_array_equal(ours, ref)
    assert not ours[::7].any() and not ours[5].any()
    f32 = verts.astype(np.float32)
    np.testing.assert_array_equal(baldwin_weber_rows(f32), _baldwin_weber_rows(f32))


def test_mma_operands_match_the_jax_tools_layout():
    bw = baldwin_weber_rows(bench_mxu_scan.scene(nblk=1)[0])
    g, gstep = bw.shape[0], bw_scan.GROUP
    # tools/bench_mxu_scan.py::main's construction
    lhs_o = np.concatenate([
        np.stack([-bw[:, 0], -bw[:, 1], -bw[:, 2], bw[:, 3]], 1).reshape(g // gstep, gstep, 4),
        np.stack([bw[:, 4], bw[:, 5], bw[:, 6], bw[:, 7]], 1).reshape(g // gstep, gstep, 4),
        np.stack([bw[:, 8], bw[:, 9], bw[:, 10], bw[:, 11]], 1).reshape(g // gstep, gstep, 4),
    ], axis=1).reshape(3 * g, 4).astype(np.float32)
    lhs_d = np.concatenate([
        np.stack([bw[:, 0], bw[:, 1], bw[:, 2], 0 * bw[:, 0]], 1).reshape(g // gstep, gstep, 4),
        np.stack([bw[:, 4], bw[:, 5], bw[:, 6], 0 * bw[:, 0]], 1).reshape(g // gstep, gstep, 4),
        np.stack([bw[:, 8], bw[:, 9], bw[:, 10], 0 * bw[:, 0]], 1).reshape(g // gstep, gstep, 4),
    ], axis=1).reshape(3 * g, 4).astype(np.float32)
    ours = bw_scan.mma_operands(torch.from_numpy(bw))
    np.testing.assert_array_equal(ours[0].numpy(), lhs_o)
    np.testing.assert_array_equal(ours[1].numpy(), lhs_d)
    o = np.random.default_rng(1).normal(size=(10, 3)).astype(np.float32)
    o4, d4 = bw_scan.ray_planes(torch.from_numpy(o), torch.from_numpy(2 * o))
    np.testing.assert_array_equal(o4.numpy(), np.concatenate([o.T, np.ones((1, 10))]))
    np.testing.assert_array_equal(d4.numpy(), np.concatenate([2 * o.T, np.zeros((1, 10))]))


@pytest.mark.parametrize("kernel", ["scalar", "mma"])
def test_plain_matches_jax_with_an_exact_reciprocal(p5, kernel):
    ns, a = p5
    ref, out = jax_keys(ns, a, kernel, exact=True), plain_keys(a, kernel)
    assert (out == ref).mean() >= 0.999
    hit_r, t_r = decode(ref, kernel == "mma")
    hit_o, t_o = decode(out, kernel == "mma")
    both = hit_r & hit_o
    assert both.sum() > 500
    np.testing.assert_allclose(t_o[both], t_r[both], rtol=1e-5, atol=0)


@pytest.mark.parametrize("kernel", ["scalar", "mma"])
def test_plain_matches_jax_with_its_bf16_reciprocal(p5, kernel):
    ns, a = p5
    mma = kernel == "mma"
    ref, out = jax_keys(ns, a, kernel, exact=False), plain_keys(a, kernel)
    hit_r, t_r = decode(ref, mma)
    hit_o, t_o = decode(out, mma)
    assert (hit_r == hit_o).mean() >= 0.99
    both = hit_r & hit_o
    close = np.abs(t_o[both] - t_r[both]) <= 8e-3 * np.abs(t_r[both])
    assert close.mean() >= 0.99
    if mma:
        same = ((out & 4095) == (ref & 4095))[both]
        assert close[same].all()


def test_round_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = 2.0 ** -10  # of TF32 at 1
    x = np.array([1.0, 1 + 2**-11, 1 + 2**-11 - 2**-23, -(1 + 2**-11), 1 + 3 * 2**-11, 3.0e-3],
                 np.float32)
    out = bw_scan.round_tf32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out[:5], np.array([one, 1 + ulp, one, -(1 + ulp), 1 + 2 * ulp],
                                                    np.float32))
    assert (out.view(np.int32) & 0x1FFF == 0).all()
    assert abs(out[5] - x[5]) <= 2.0 ** -11 * x[5]


def test_cpu_wrappers_run_the_plain_versions(p5):
    _, a = p5
    sub = {k: (v[:, :256].contiguous() if k in ("o4", "d4") else v) for k, v in a.items()}
    assert torch.equal(bw_scan.bw_scan_cuda(sub["bw"], sub["o4"][:3], sub["d4"][:3]),
                       bw_scan.bw_scan_plain(sub["bw"], sub["o4"], sub["d4"]))
    assert torch.equal(bw_scan.bw_mma_cuda(sub["lhs_o"], sub["lhs_d"], sub["o4"], sub["d4"]),
                       bw_scan.bw_mma_plain(sub["lhs_o"], sub["lhs_d"], sub["o4"], sub["d4"]))
    assert bw_scan.LAUNCHES == 0 and bw_scan.MMA_LAUNCHES == 0


def test_tool_runs_on_cpu_at_a_tiny_size(capsys):
    out = bench_mxu_scan.run(device="cpu", nblk=1, reps=1)
    assert out["rays"] == N and out["parity"]["agree"] >= 0.99
    assert 0.05 < out["parity"]["hit_frac"] < 0.2
    text = capsys.readouterr().out
    assert "hit agree: " in text and "Gtri-tests/s" in text
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_mxu_scan.run()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def same_scalar_key(key: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """The scalar keys agree once the low 12 bits are dropped: t to 11
    mantissa bits, a miss as a miss."""
    return (key & -4096) == (ref & -4096)


def same_winner(key: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Two matrix keys name the same winner: both miss, or both hit the
    same triangle."""
    hit, _ = bw_scan.hit_t(key, True)
    hit_r, _ = bw_scan.hit_t(ref, True)
    return (hit == hit_r) & (~hit | ((key & 4095) == (ref & 4095)))


@pytest.mark.gpu
def test_scalar_kernel_matches_plain_on_card(cuda):
    a = bench_mxu_scan.inputs(cuda, nblk=4)
    before = bw_scan.LAUNCHES
    key = bw_scan.bw_scan_cuda(a["bw"], a["o4"], a["d4"])
    torch.cuda.synchronize()
    assert bw_scan.LAUNCHES == before + 1
    ref = bw_scan.bw_scan_plain(a["bw"], a["o4"], a["d4"])
    assert float(same_scalar_key(key, ref).double().mean()) >= 0.999
    hit, t = bw_scan.hit_t(key, False)
    hit_r, t_r = bw_scan.hit_t(ref, False)
    both = hit & hit_r
    assert int(both.sum()) > 1000
    rel = ((t[both] - t_r[both]).abs() / t_r[both]).double()
    assert float(torch.quantile(rel.cpu(), 0.999)) <= 1e-4
    with pytest.raises(ValueError, match="triangles"):
        bw_scan.bw_scan_cuda(a["bw"][:24].contiguous(), a["o4"], a["d4"])


@pytest.mark.gpu
def test_mma_kernel_matches_tf32_plain_and_scalar_on_card(cuda):
    a = bench_mxu_scan.inputs(cuda, nblk=4)
    n = a["o4"].shape[1] - 40  # a ragged last warp
    o4, d4 = a["o4"][:, :n].contiguous(), a["d4"][:, :n].contiguous()
    before = bw_scan.MMA_LAUNCHES
    key = bw_scan.bw_mma_cuda(a["lhs_o"], a["lhs_d"], o4, d4)
    torch.cuda.synchronize()
    assert bw_scan.MMA_LAUNCHES == before + 1 and key.shape == (n,)
    ref = bw_scan.bw_mma_plain(a["lhs_o"], a["lhs_d"], o4, d4, tf32=True)
    assert float(same_winner(key, ref).double().mean()) >= 0.999
    scalar = bw_scan.bw_scan_cuda(a["bw"], o4, d4)
    hit_s, _ = bw_scan.hit_t(scalar, False)
    hit_m, _ = bw_scan.hit_t(key, True)
    assert float((hit_s == hit_m).double().mean()) >= 0.99
    assert int(hit_m.sum()) > 1000
    with pytest.raises(ValueError, match="triangles"):
        bw_scan.bw_mma_cuda(a["lhs_o"][:96].contiguous(), a["lhs_d"][:96].contiguous(), o4, d4)
