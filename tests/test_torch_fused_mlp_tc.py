"""The design of the fused MLP chain's kernels (K9 forward, K10 backward,
`csrc/fused_mlp.cu`) on the CPU, where the kernels cannot run (no nvcc, no
card: `chip_smoke.py` holds them against their plain versions on the H100):

  * the chain's weights as `fused_mlp.pack_chain` hands them to the kernels:
    bf16 W and W^T read back by the PTX ISA's fragment layouts (mma.sync
    m16n8k16), fp32 W^T as TF32 hi / lo pairs (m16n8k8), fp32 W as it is with
    its rows padded to a multiple of 4, all with zero padding, for
    run_mip_nerf's three chains and widths off 16 (3, 63, 257, 319);
  * the fp32 products' admissibility: a torch emulation of the kernels' fp32
    arithmetic through `fused_chain_reference` at run_mip_nerf's widths,
    against the JAX Pallas chain in interpret mode (forward) and `jax.vjp` of
    the JAX plain chain (backward), at the fp32 tolerance `chip_smoke.py`
    holds K9 / K10 to (`TOL_CHAIN[False]`, 1e-4 relative norm). Two
    emulations: the kernels' own (the forward in fp32, the backward's g W^T
    as 3xTF32, dW in fp32) and 3xTF32 in every forward and backward product
    (what a forward on the tensor cores would give; on the card its ReLU
    decisions differ from the plain chain's in a few units in 10^7, which
    this size does not reach: PERF.md section 6);
  * the row tile and shared memory (`tile_rows`, `tile_smem_bytes`, pinned to
    `ChainSmem` in csrc/fused_mlp.cu), `bwd_workspace_bytes` and the dW
    GEMM's row splits (`dw_splits`), pinned for the three chains;
  * `FusedChain` packs once a forward and its backward takes those packs;
    a chain that no row tile holds is refused before any kernel is built.

Inputs are made with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_experiments_tpu.ops import fused_mlp as jfused
from nerf_experiments_tpu_torch.ops import fused_mlp as tfused
from nerf_experiments_tpu_torch.ops import train_megakernel as ttrain
from test_torch_flagship_tc import read_fragments, unpad
from test_torch_fused_mlp import chain, jax_plain_chain, rel_norm
from test_torch_hygiene import fake_cuda

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# run_mip_nerf's chains (IPE 10 levels, NerfMLP 4 x 256 in 2 segments, Fourier
# 4 direction levels): segment 1, segment 2 (hidden + density), colour head
MIP_CHAINS = {
    "segment1": (63, 256, 256, 256, 256, 256),
    "segment2": (319, 256, 256, 256, 256, 257),
    "colour": (280, 128, 3),
}
OFF16_CHAINS = {"off16": (63, 257, 3), "one_layer": (319, 3)}
TOL_CHAIN_FP32 = 1e-4  # chip_smoke.TOL_CHAIN[False]


def r16(x):
    return (x + 15) // 16 * 16


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("name", sorted({**MIP_CHAINS, **OFF16_CHAINS}))
def test_chain_packs_follow_the_mma_fragment_layout(name, bf16):
    dims = {**MIP_CHAINS, **OFF16_CHAINS}[name]
    _, port = chain(dims, seed=len(dims) + dims[0])
    fwd, bwd = tfused.pack_chain(port, bf16, True, "cpu")
    assert len(fwd) == len(bwd) == len(port)
    for layer, f, b, k, n in zip(port, fwd, bwd, dims[:-1], dims[1:]):
        w = layer.w.detach()
        kk = 16 if bf16 else 8
        assert tuple(b.shape) == (r16(k) // 8, r16(n) // kk, 32, 4)
        got_t = unpad(read_fragments(b, bf16), [n], [k])
        if bf16:
            assert tuple(f.shape) == (r16(n) // 8, r16(k) // 16, 32, 4)
            rounded = w.to(torch.bfloat16).float().numpy()
            np.testing.assert_array_equal(unpad(read_fragments(f, True), [k], [n]), rounded)
            np.testing.assert_array_equal(got_t, rounded.T)
        else:
            # W as it is, rows padded with zeros to a multiple of 4
            assert f.dtype == torch.float32 and tuple(f.shape) == (k, (n + 3) // 4 * 4)
            assert torch.equal(f[:, :n], w) and not f[:, n:].any()
            np.testing.assert_allclose(got_t, w.numpy().T, rtol=2.0 ** -21, atol=0.0)
            hi = b[..., :2].contiguous()  # the hi halves are TF32 values
            assert torch.equal(ttrain.tf32_round(hi), hi)


def test_fp32_forward_without_backward_packs_nothing_for_the_tensor_cores():
    _, port = chain(MIP_CHAINS["colour"], seed=3)
    fwd, bwd = tfused.pack_chain(port, False, False, "cpu")
    assert bwd is None and [tuple(f.shape) for f in fwd] == [(280, 128), (128, 4)]
    assert all(f.data_ptr() % 16 == 0 for f in fwd)  # read as float4
    assert torch.equal(fwd[0], port[0].w) and torch.equal(fwd[1][:, :3], port[1].w)


def tf32x3(a, b):
    """a @ b as the kernels' fp32 tensor-core products: a = hi + lo, b = hi' +
    lo', a b ~ lo hi' + hi lo' + hi hi' (each exact in fp32, summed in fp32)."""
    ah = ttrain.tf32_round(a)
    al = ttrain.tf32_round(a - ah)
    bh = ttrain.tf32_round(b)
    bl = ttrain.tf32_round(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def emulated_matmul(forward_tf32: bool):
    """`fused_mlp._matmul` (fp32) with the kernels' products: the backward's g
    W^T as 3xTF32, dW = a^T g in fp32 (phase B on the CUDA cores), the
    forward in fp32 or, with `forward_tf32`, as 3xTF32 too."""

    class Product(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, w):
            ctx.save_for_backward(a, w)
            return tf32x3(a, w) if forward_tf32 else a @ w

        @staticmethod
        def backward(ctx, g):
            a, w = ctx.saved_tensors
            return tf32x3(g, w.t()), a.t() @ g

    def matmul(a, w, bf16):
        assert not bf16
        return Product.apply(a, w)

    return matmul


@pytest.mark.parametrize("forward_tf32", [False, True], ids=["kernels", "every_product"])
@pytest.mark.parametrize("name", sorted(MIP_CHAINS))
def test_3xtf32_products_meet_the_fp32_tolerance_against_jax(name, forward_tf32, monkeypatch):
    """y against the JAX Pallas chain in interpret mode, dx and every dW / db
    against `jax.vjp` of the JAX plain chain, by relative norm; 600 rows span
    two of the JAX kernel's 512-row tiles."""
    dims = MIP_CHAINS[name]
    layers, port = chain(dims, seed=11)
    rng = np.random.default_rng(12)
    x = rng.uniform(-1.0, 1.0, size=(600, dims[0])).astype(np.float32)
    g = rng.normal(size=(600, dims[-1])).astype(np.float32)
    want_y = jfused.fused_chain(jnp.asarray(x), layers, interpret=True)
    jlayers = jax.tree_util.tree_map(jnp.asarray, layers)
    _, vjp = jax.vjp(lambda x, ls: jax_plain_chain(x, ls, None), jnp.asarray(x), jlayers)
    jdx, jgrads = vjp(jnp.asarray(g))

    monkeypatch.setattr(tfused, "_matmul", emulated_matmul(forward_tf32))
    xt, gt = torch.as_tensor(x), torch.as_tensor(g)
    y = tfused.fused_chain_reference(xt, port)
    dx, dws, dbs = tfused.fused_chain_bwd_reference(xt, port, gt)
    monkeypatch.undo()
    plain = tfused.fused_chain_bwd_reference(xt, port, gt)
    assert not torch.equal(dx, plain[0])  # the emulation took effect

    errs = {"y": rel_norm(y, want_y), "dx": rel_norm(dx, jdx)}
    for i, jg in enumerate(jgrads):
        errs[f"dW{i}"] = rel_norm(dws[i], jg["w"])
        errs[f"db{i}"] = rel_norm(dbs[i], jg["b"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL_CHAIN_FP32, (worst, errs[worst])


# ChainSmem of csrc/fused_mlp.cu at 64-row tiles: two compute-type tiles of
# 64 x (round16(widest) + 16 bytes), the warps' rings (32,768 bytes bf16,
# 49,152 fp32), and in the backward the fp32 cotangent staging tile (bf16)
# and 2 mask words a hidden column
SMEM_64 = {  # (bf16, backward): bytes
    "segment1": {(True, False): 100_352, (True, True): 175_104,
                 (False, False): 182_272, (False, True): 190_464},
    "segment2": {(True, False): 116_736, (True, True): 191_488,
                 (False, False): 215_040, (False, True): 223_232},
    "colour": {(True, False): 108_544, (True, True): 143_360,
               (False, False): 198_656, (False, True): 199_680},
}


@pytest.mark.parametrize("name", sorted(MIP_CHAINS))
def test_tile_rows_and_shared_memory_are_pinned(name):
    dims = MIP_CHAINS[name]
    for (bf16, backward), want in SMEM_64[name].items():
        assert tfused.tile_smem_bytes(dims, bf16, 64, backward) == want
        assert tfused.tile_rows(dims, bf16, backward) == 64
        assert tfused.tile_smem_bytes(dims, bf16, 32, backward) < want


@pytest.mark.parametrize("dims,bf16,backward,want", [
    ((512, 512, 512), True, True, 32),     # 64 rows: 302,080 bytes
    ((512, 512, 512), False, False, 32),   # 64 rows: 313,344
    ((1024, 1024), True, False, 32),
    ((704, 8), False, False, 32),          # 230,400 bytes at 32 rows
    ((720, 8), False, False, None),        # 234,496
    ((768, 768, 768), True, True, None),   # 233,984
    ((4096, 4096), True, False, None),
])
def test_tile_rows_refuse_what_no_tile_holds(dims, bf16, backward, want):
    assert tfused.tile_rows(dims, bf16, backward) == want
    if want is not None:
        assert tfused.tile_smem_bytes(dims, bf16, want, backward) <= ttrain.SMEM_LIMIT


@pytest.mark.parametrize("name,bf16,want", [
    ("segment1", False, 2_481_979_392), ("segment1", True, 1_912_078_336),
    ("segment2", False, 2_751_463_424), ("segment2", True, 2_047_344_640),
    ("colour", False, 565_182_464), ("colour", True, 351_272_960),
])
def test_bwd_workspace_bytes_are_pinned(name, bf16, want):
    """Every layer's input in the compute type and every output cotangent in
    fp32 at one Mip step's 262,144 rows (2.56 GiB for segment 2 in fp32)."""
    dims = MIP_CHAINS[name]
    got = tfused.bwd_workspace_bytes(262_144, dims, bf16)
    assert got == 262_144 * (sum(dims[:-1]) * (2 if bf16 else 4) + sum(dims[1:]) * 4) == want


@pytest.mark.parametrize("name,splits", [("segment1", (30, 10, 1)), ("segment2", (22, 10, 1)),
                                         ("colour", (64, 10, 1))])
def test_dw_splits_are_pinned(name, splits):
    """128 x 128 output tiles x splits >= 4 x 132 blocks, >= 4,096 rows a
    split, at most 64: at 262,144, 40,037 and 1,000 rows."""
    assert tuple(tfused.dw_splits(n, MIP_CHAINS[name]) for n in (262_144, 40_037, 1000)) == splits


def test_fused_chain_packs_once_and_its_backward_takes_the_packs(monkeypatch):
    """One `pack_chain` a forward (W^T too when a backward follows); the
    wrappers get those packs, the backward the pair the forward made."""
    calls, seen = [], {}
    real_pack = tfused.pack_chain

    def pack(layers, bf16, backward, dev):
        calls.append(backward)
        return real_pack(layers, bf16, backward, dev)

    def fwd(x, layers, bf16, packed=None):
        seen["fwd"] = packed
        return tfused.fused_chain_reference(x, layers, torch.bfloat16 if bf16 else None)

    def bwd(x, layers, g, bf16, packed=None):
        seen["bwd"] = packed
        return tfused.fused_chain_bwd_reference(x, layers, g, torch.bfloat16 if bf16 else None)

    monkeypatch.setattr(tfused, "pack_chain", pack)
    monkeypatch.setattr(tfused, "fused_mlp_fwd_cuda", fwd)
    monkeypatch.setattr(tfused, "fused_mlp_bwd_cuda", bwd)
    for bf16 in (False, True):
        calls.clear()
        _, port = chain((12, 32, 17), seed=4)
        wb = [t.requires_grad_(True) for layer in port for t in (layer.w, layer.b)]
        x = torch.randn((9, 12), generator=torch.Generator().manual_seed(5), requires_grad=True)
        y = tfused.FusedChain.apply(x, bf16, True, *wb)
        assert calls == [True] and seen["fwd"] is not None
        y.square().sum().backward()
        assert calls == [True]  # the backward packed nothing
        assert seen["bwd"][0] is seen["fwd"] and len(seen["bwd"][1]) == len(port)
        with torch.no_grad():
            tfused.FusedChain.apply(x, bf16, False, *wb)
        assert calls == [True, False]


@pytest.mark.parametrize("bf16", [False, True])
def test_fused_chain_refuses_a_chain_no_tile_holds(bf16, tmp_path, monkeypatch):
    """On the card a chain too wide for any row tile raises, before any
    kernel is built or any weight packed (no quiet fall back to the plain
    version)."""
    from nerf_experiments_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(cuda_build, "library", lambda: pytest.fail("kernels built"))
    _, port = chain((8, 4096, 3), seed=6)
    with pytest.raises(ValueError, match="no row tile"):
        tfused.fused_chain(fake_cuda(2, 8), port, torch.bfloat16 if bf16 else None)
