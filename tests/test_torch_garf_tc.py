"""The tensor-core design of the GARF kernels (K5 train, K6 render) on the
CPU, where the kernels cannot run (no nvcc, no card: `chip_smoke.py` holds
them against their plain versions on the H100):

  * the packed weights of linears 1..9 (`garf_megakernel.packed_weights`:
    the forward product's B and the backward product's W^T, with the
    two-part inputs [z1 | pos] and [ci | dir] and the padded widths 129 and
    3), read back by the PTX ISA's fragment layouts, against every layer's
    weights, fp32 and bf16, with zero padding;
  * 3xTF32 admissibility: a torch emulation of the fp32 route's products
    (hi / lo TF32 split, three products, in the forward and in both backward
    products; linear 0 stays plain fp32 as on the CUDA cores) through the
    plain GARF forward and backward at full width, against the JAX kernel in
    interpret mode at the fp32 tolerance `chip_smoke.py` holds K5 to (1e-4
    relative norm), for every family and gamma of `chip_smoke.GARF_FAMILIES`.
    The net has no ReLU whose mask a product's 2^-21 error could flip, which
    is what keeps the flagship K4's fp32 forward off the tensor cores;
  * the row tile and shared memory (`tile_rows`, `tile_smem_bytes`, pinned to
    `GarfSmem` in csrc/garf_common.cuh) and `train_workspace_bytes`, pinned;
  * the render wrapper's cache of packed weights (`render_weights`).
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_experiments_tpu.models import garf as jgarf
from nerf_experiments_tpu.ops import garf_megakernel as jgm
from nerf_experiments_tpu_torch.models import garf as tgarf
from nerf_experiments_tpu_torch.ops import garf_megakernel as tgm
from nerf_experiments_tpu_torch.ops import train_megakernel as ttrain
from test_torch_flagship_tc import read_fragments, unpad
from test_torch_garf_train import jax_tree, kernel_inputs, named, net_cfgs, numpy_tree

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# chip_smoke.GARF_FAMILIES: (activation, gamma)
FAMILIES = [("gauss", 1.0), ("gabor", 1.0), ("gabor", 0.37), ("sarf", 1.0), ("sarf", 0.37)]


def cfg_of(activation, bf16):
    _, tcfg = net_cfgs(activation)
    return dataclasses.replace(tcfg, compute_dtype=torch.bfloat16 if bf16 else None)


@pytest.mark.parametrize("bf16", [False, True])
def test_packed_weights_read_back_to_every_layer(bf16):
    cfg = cfg_of("gabor", bf16)
    params = tgarf.radiance_init(torch.Generator().manual_seed(3), cfg)
    fwd, bwd, biases, w0, w_density = tgm.packed_weights(params, cfg, "cpu", backward=True)
    lins = tgm._linears(params)
    assert len(fwd) == len(bwd) == len(biases) == len(lins) == len(tgm.LAYER_PARTS) == 10
    assert fwd[0] is None and bwd[0] is None  # linear 0 runs on the CUDA cores
    dt = torch.bfloat16 if bf16 else torch.float32
    want = lambda w: w.detach().to(dt).float().numpy()
    exact = dict(rtol=0.0, atol=0.0) if bf16 else dict(rtol=2.0 ** -21, atol=0.0)
    for i in range(1, 10):
        k_parts, out = tgm.LAYER_PARTS[i]
        w = lins[i].w.detach()
        assert tuple(w.shape) == (sum(k_parts), out)
        n_fwd = 128 if i == tgm.DENSITY_LAYER else out
        assert fwd[i].dtype == dt and bwd[i].dtype == dt
        # unpad checks that the padding (K parts and N to 16) holds zeros
        np.testing.assert_allclose(unpad(read_fragments(fwd[i], bf16), k_parts, [n_fwd]),
                                   want(w[:, :n_fwd]), **exact)
        np.testing.assert_allclose(unpad(read_fragments(bwd[i], bf16), [out], k_parts),
                                   want(w.t()), **exact)
        assert torch.equal(biases[i], lins[i].b.detach())
    # the two-part inputs take 9 (bf16) or 18 (fp32) k-steps: 128 + 3 padded to 144
    assert fwd[4].shape[1] == fwd[8].shape[1] == (9 if bf16 else 18)
    assert bwd[4].shape[0] == bwd[8].shape[0] == 18  # n parts 128 + 16
    assert fwd[9].shape[0] == 2 and bwd[9].shape[1] == (1 if bf16 else 2)  # 3 -> 16
    assert torch.equal(w0, lins[0].w.detach().to(dt))
    assert torch.equal(w_density, lins[7].w.detach()[:, 128].to(dt))


def tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels' fp32 route computes it: a = hi + lo, b = hi' +
    lo' (TF32 parts), lo hi' + hi lo' + hi hi', each product exact in fp32
    for TF32 factors, accumulated in fp32."""
    ah = ttrain.tf32_round(a)
    al = ttrain.tf32_round(a - ah)
    bh = ttrain.tf32_round(b)
    bl = ttrain.tf32_round(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


class Tf32x3Linear(torch.autograd.Function):
    """x W + b with 3xTF32 products in the forward (tile forward), the input
    cotangent g W^T (tile backward) and the weight gradient x^T g (phase B)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return tf32x3(x, w) + b

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return tf32x3(g, w.t()), tf32x3(x.t(), g), g.sum(0)


def tf32x3_linear(layer, x, compute_dtype=None):
    """`linear_apply` with the fp32 route's products; linear 0 (K = 3) runs on
    the CUDA cores in plain fp32."""
    assert compute_dtype is None
    if layer.w.shape[0] == 3:
        return x @ layer.w + layer.b
    return Tf32x3Linear.apply(x, layer.w, layer.b)


def rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("activation,gamma", FAMILIES)
def test_3xtf32_products_meet_the_fp32_tolerance_against_jax(activation, gamma):
    jcfg, tcfg = net_cfgs(activation)
    tree = numpy_tree(jgarf.radiance_init(jax.random.PRNGKey(17), jcfg))
    params = tgarf.from_numpy(tree, tcfg)
    inputs = kernel_inputs(4, 16, seed=18)
    rgb, w, grads, do, dd = jgm.garf_radiance_train_grads(
        jax_tree(tree), jcfg, *map(jnp.asarray, inputs), tile_rays=4, interpret=True,
        act_anneal=gamma)
    args = (params, tcfg, *map(torch.as_tensor, inputs), gamma)
    with mock.patch.object(tgarf, "linear_apply", tf32x3_linear):
        got = tgm.garf_radiance_train_grads_reference(*args)
    plain = tgm.garf_radiance_train_grads_reference(*args)
    assert not torch.equal(got[2]["density2.linear.1.w"], plain[2]["density2.linear.1.w"])
    want = named(grads)
    assert set(got[2]) == set(want)
    errs = {"rgb": rel_norm(got[0], rgb), "weights": rel_norm(got[1], w),
            "d_origs": rel_norm(got[3], do), "d_dirs": rel_norm(got[4], dd)}
    errs.update({k: rel_norm(v.detach(), want[k]) for k, v in got[2].items()})
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-4, (worst, errs[worst])  # chip_smoke.TOL_K4_FP32


def test_tile_rows_and_shared_memory_are_pinned():
    """`GarfSmem`'s sizes in csrc/garf_common.cuh: bf16 takes 64-row tiles, fp32
    (operands kept fp32 for 3xTF32) 32-row tiles, as a 64-row fp32 tile
    would pass the block's 227 KB."""
    f32, b16 = cfg_of("gauss", False), cfg_of("gauss", True)
    assert tgm.tile_rows(b16) == 64 and tgm.tile_rows(f32) == 32
    assert tgm.tile_smem_bytes(b16, 64) == 190_464
    assert tgm.tile_smem_bytes(f32, 32) == 195_584
    assert tgm.tile_smem_bytes(f32, 64) == 342_016 > ttrain.SMEM_LIMIT
    assert tgm.tile_smem_bytes(b16, 128) > ttrain.SMEM_LIMIT


@pytest.mark.parametrize("activation,bf16,n,s,blocks,want", [
    ("gauss", False, 4096, 192, 4096, 16_790_758_144),  # one ray a block
    ("gabor", True, 4096, 192, 4096, 11_389_543_168),
    ("sarf", False, 256, 50, 256, 278_945_296),         # ragged: one ray, 2 tiles of 32
    ("gauss", True, 1000, 20, 334, 296_621_984),        # 3 rays a 64-row tile
])
def test_train_workspace_bytes_is_pinned(activation, bf16, n, s, blocks, want):
    cfg = cfg_of(activation, bf16)
    lay = tgm.train_layout(cfg)
    per_feature = 2 if activation == "gabor" else 1
    assert (lay["act"], lay["cot"]) == (3462, 1798)
    assert lay["block_part"] == 4096 + per_feature * 2688
    assert tgm._blocks(n, s, tgm.tile_rows(cfg)) == blocks
    rows = n * s
    assert tgm.train_workspace_bytes(cfg, n, s) == \
        rows * (3462 * (2 if bf16 else 4) + (1798 + 6) * 4) + blocks * lay["block_part"] * 4 \
        + tgm._splits(rows) * lay["split_part"] * 4 == want


def test_render_weights_are_packed_again_only_when_a_layer_changes():
    cfg = cfg_of("gauss", True)
    params = tgarf.radiance_init(torch.Generator().manual_seed(0), cfg)
    first = tgm.render_weights(params, cfg, "cpu")
    assert tgm.render_weights(params, cfg, "cpu") is first
    with torch.no_grad():  # an optimizer step writes in place
        params.density2.linear[1].w.add_(1.0)
    second = tgm.render_weights(params, cfg, "cpu")
    assert second is not first
    assert not torch.equal(second[0][5], first[0][5])
    assert torch.equal(second[0][2], first[0][2])
    with torch.no_grad():  # a bias counts too
        params.color.linear[0].b.add_(1.0)
    assert tgm.render_weights(params, cfg, "cpu") is not second
    other = tgarf.radiance_init(torch.Generator().manual_seed(0), cfg)
    assert tgm.render_weights(other, cfg, "cpu") is not tgm.render_weights(params, cfg, "cpu")
