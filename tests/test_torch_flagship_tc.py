"""The tensor-core design of the flagship kernels (K2 render, K4 train) on the
CPU, where the kernels cannot run (no nvcc, no card: `chip_smoke.py` holds
them against their plain versions on the H100):

  * `pack_b`, the weights' fragment order, against the layout the PTX ISA
    gives mma.sync's B fragments (m16n8k16 bf16, m16n8k8 tf32), read back
    here by that formula and not by the packer's own reshapes;
  * the packed weights of every layer, read back and run through the plain
    versions, against the JAX kernels in interpret mode (the tolerances of
    `tests/test_torch_train.py` and `tests/test_torch_models.py`);
  * a torch emulation of the kernels' 3xTF32 products in the plain forward
    against the JAX fp32 kernel, at the fp32 tolerance `chip_smoke.py` holds
    the kernels to (1e-4 abs): the split reaches it before any chip run;
  * an emulation of the train kernel's fp32 tile (the forward in fp32, g W^T
    as 3xTF32, dW in fp32) against the JAX fp32 train kernel, by relative
    norm at `chip_smoke.TOL_K4_FP32` (1e-4);
  * `train_workspace_bytes` pinned to the workspace layout;
  * widths: hidden and colour widths that are not multiples of 16 (packed
    zero-padded, read back against the JAX kernels), the row tile each width
    takes and the shared memory behind it (`tile_rows`), the train kernel's
    route at each width (`train_route`: the bf16 or fp32 tile by the compute
    type, or none) and its launch counter, and the configs too wide for any
    tile routed to the plain step (`can_fuse_train_step`);
  * `packed_weights`' one gather against `pack_b` per operand, and the render
    kernel's cache of packed weights (`render_weights`);
  * `NerfMLPDef.full_alphas` with an `Identity` direction encoder (0 levels,
    as the JAX package's `getattr(enc, "levels", 0)`).
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_experiments_tpu.encodings.fourier import Barf as JBarf
from nerf_experiments_tpu.models import nerf_mlp as jmlp
from nerf_experiments_tpu.ops import sampling as jsampling
from nerf_experiments_tpu.ops.train_megakernel import flagship_render as jrender_kernel
from nerf_experiments_tpu.ops.train_megakernel import flagship_train_grads as jtrain_kernel
from nerf_experiments_tpu_torch.encodings.fourier import Barf as TBarf
from nerf_experiments_tpu_torch.encodings.fourier import Identity
from nerf_experiments_tpu_torch.models import common as tcommon
from nerf_experiments_tpu_torch.models import nerf_mlp as tmlp
from nerf_experiments_tpu_torch.ops import train_megakernel as ttrain
from nerf_experiments_tpu_torch.systems import barf as tbarf
from nerf_experiments_tpu_torch.systems.barf import NerfMLPDef

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def cfgs(n_hidden=2, hidden_dim=32, bf16=False):
    enc = dict(scale=1.0, include_identity=True)
    kw = dict(n_hidden=n_hidden, hidden_dim=hidden_dim, n_segments=2,
              delayed_direction=True, delayed_density=False)
    return (jmlp.NerfMLPConfig(position_encoder=JBarf(levels=4, **enc),
                               direction_encoder=JBarf(levels=2, **enc),
                               compute_dtype=jnp.bfloat16 if bf16 else None, **kw),
            tmlp.NerfMLPConfig(position_encoder=TBarf(levels=4, **enc),
                               direction_encoder=TBarf(levels=2, **enc),
                               compute_dtype=torch.bfloat16 if bf16 else None, **kw))


def inputs(n, s, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    ts, te = map(np.asarray, jsampling.sample_stratified(None, n, s, 2.0, 6.0, "equidistant"))
    targets = rng.uniform(size=(n, 3)).astype(np.float32)
    return o, d, ts, te, targets


def close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port.detach().float()), np.asarray(ref, np.float32),
                               **tol)


def read_fragments(packed: torch.Tensor, bf16: bool):
    """B (K, N) from a packed operand, by the PTX ISA's fragment layouts: lane
    4 g + t of n8 tile nt holds column 8 nt + g; m16n8k16 (bf16): rows 2 t +
    e, then + 8, of k-step ks (16 rows); m16n8k8 (tf32): rows t and t + 4 of
    k-step ks (8 rows), hi then lo. Returns (hi + lo) for tf32."""
    p = packed.float().numpy()
    nt_n, ks_n = p.shape[:2]
    kk = 16 if bf16 else 8
    out = np.full((ks_n * kk, nt_n * 8), np.nan, np.float64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        cols = np.arange(nt_n)[:, None] * 8 + g
        ks = np.arange(ks_n)[None, :] * kk
        if bf16:
            for e, dk in enumerate((0, 1, 8, 9)):
                out[ks + 2 * t + dk, cols] = p[:, :, lane, e]
        else:
            for h in range(2):
                hi, lo = p[:, :, lane, h], p[:, :, lane, 2 + h]
                out[ks + t + 4 * h, cols] = hi.astype(np.float64) + lo
    assert not np.isnan(out).any()
    return out


def unpad(mat, k_parts, n_parts):
    """Drop the zero padding that `pack_b` puts after each part."""
    r16 = lambda x: (x + 15) // 16 * 16
    k_off = np.concatenate([[0], np.cumsum([r16(k) for k in k_parts])])
    n_off = np.concatenate([[0], np.cumsum([r16(n) for n in n_parts])])
    rows = np.concatenate([np.arange(o, o + k) for o, k in zip(k_off, k_parts)])
    cols = np.concatenate([np.arange(o, o + n) for o, n in zip(n_off, n_parts)])
    keep = np.zeros(mat.shape, bool)
    keep[np.ix_(rows, cols)] = True
    assert not mat[~keep].any(), "padding must be zero"
    return mat[np.ix_(rows, cols)]


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("k_parts,n_parts", [([63], [32]), ([32, 63], [32]), ([3], [16]),
                                             ([33], [32, 27]), ([16], [3])])
def test_pack_b_follows_the_mma_fragment_layout(bf16, k_parts, n_parts):
    rng = np.random.default_rng(len(k_parts) * 7 + sum(k_parts))
    mat = torch.as_tensor(rng.normal(size=(sum(k_parts), sum(n_parts))).astype(np.float32))
    packed = ttrain.pack_b(mat, k_parts, n_parts, bf16)
    kp, np_ = (sum((x + 15) // 16 * 16 for x in parts) for parts in (k_parts, n_parts))
    assert packed.shape == (np_ // 8, kp // (16 if bf16 else 8), 32, 4)
    assert packed.dtype == (torch.bfloat16 if bf16 else torch.float32)
    got = unpad(read_fragments(packed, bf16), k_parts, n_parts)
    if bf16:
        np.testing.assert_array_equal(got, mat.to(torch.bfloat16).float().numpy())
    else:  # hi + lo carries fp32 to within lo's own TF32 rounding
        np.testing.assert_allclose(got, mat.numpy(), rtol=2.0 ** -21, atol=0.0)


def test_tf32_round_is_round_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 + 2.0 ** -20, 1.0 + 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 3.0e-3, -7.5e5])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10)])
    got = ttrain.tf32_round(x)
    assert torch.equal(got[:5], want)
    bits = got.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    r = torch.randn(10000, generator=torch.Generator().manual_seed(0)) * 100
    err = (ttrain.tf32_round(r) - r).abs() / r.abs()
    assert float(err.max()) <= 2.0 ** -11


def params_from_packs(tcfg, params, bf16):
    """The layers' weights read back from `packed_weights` (forward packs and
    the density column; the backward packs checked to hold W^T), as a
    NerfMLP with the same biases."""
    fwd, bwd, biases, w_density = ttrain.packed_weights(params, tcfg, "cpu", backward=True)
    D = tcfg.hidden_dim
    C = params.color[0].w.shape[1]
    parts = ttrain._layer_parts(tcfg, D, C)
    last = 2 * tcfg.n_hidden + 1
    layers = ttrain._layers(params)
    new_ws = []
    for i, (layer, (k_parts, n_out)) in enumerate(zip(layers, parts)):
        n_fwd = D if i == last else n_out
        w = unpad(read_fragments(fwd[i], bf16), k_parts, [n_fwd])
        if i == last:
            w = np.concatenate([w, w_density.float().numpy()[:, None]], axis=1)
        wt = unpad(read_fragments(bwd[i], bf16), [n_out], k_parts)
        np.testing.assert_allclose(wt.T, w, rtol=2.0 ** -21, atol=0.0)
        close(biases[i], layer.b.detach().numpy(), rtol=0, atol=0)
        new_ws.append(torch.as_tensor(w.astype(np.float32)))
    rebuilt = tmlp.init(torch.Generator().manual_seed(0), tcfg)
    with torch.no_grad():
        for dst, src, w in zip(ttrain._layers(rebuilt), layers, new_ws):
            dst.w.copy_(w)
            dst.b.copy_(src.b)
    return rebuilt


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n_hidden", [1, 2])
def test_packed_weights_through_the_plain_versions_match_jax_kernels(bf16, n_hidden):
    check_packed_against_jax_kernels(bf16, n_hidden, hidden_dim=32)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("hidden_dim", [48, 40])
def test_packed_weights_at_widths_off_16_match_jax_kernels(bf16, hidden_dim):
    """Colour widths 24 and 20 (and hidden 40) are padded to 16 in the packs
    and read back exactly."""
    check_packed_against_jax_kernels(bf16, 1, hidden_dim)


def check_packed_against_jax_kernels(bf16, n_hidden, hidden_dim):
    jcfg, tcfg = cfgs(n_hidden=n_hidden, hidden_dim=hidden_dim, bf16=bf16)
    tree = jax.tree_util.tree_map(np.asarray, jmlp.init(jax.random.PRNGKey(n_hidden), jcfg))
    params = tmlp.from_numpy(tree, tcfg)
    rebuilt = params_from_packs(tcfg, params, bf16)
    o, d, ts, te, targets = inputs(8, 8, seed=n_hidden)
    a_pos, a_dir = 3.0, 1.5
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tol = dict(rtol=0.0, atol=2e-2) if bf16 else dict(rtol=1e-5, atol=1e-6)

    want = jrender_kernel(jt, jcfg, *map(jnp.asarray, (o, d, ts, te)), jnp.asarray(a_pos),
                          jnp.asarray(a_dir), tile_rays=4, interpret=True, return_weights=True)
    got = ttrain.flagship_render(rebuilt, tcfg, *map(torch.as_tensor, (o, d, ts, te)),
                                 a_pos, a_dir, return_weights=True)
    for a, b in zip(got, want):
        close(a, b, **tol)

    want = jtrain_kernel(jt, jcfg, *map(jnp.asarray, (o, d, ts, te, targets)), a_pos, a_dir,
                         tile_rays=4, interpret=True)
    got = ttrain.flagship_train_grads(rebuilt, tcfg, *map(torch.as_tensor,
                                                           (o, d, ts, te, targets)),
                                      a_pos, a_dir)
    grad_tol = dict(rtol=0.0, atol=2e-2) if bf16 else dict(rtol=2e-4, atol=1e-6)
    close(got[0], want[0], **tol)
    close(got[2], want[2], **(grad_tol if bf16 else dict(rtol=1e-4, atol=1e-6)))
    close(got[3], want[3], **(grad_tol if bf16 else dict(rtol=1e-4, atol=1e-6)))
    for i, seg in enumerate(want[1]["segments"]):
        for j, layer in enumerate(seg["layers"]):
            for k in ("w", "b"):
                close(got[1][f"segments.{i}.layers.{j}.{k}"], layer[k], **grad_tol)
    for c, layer in enumerate(want[1]["color"]):
        for k in ("w", "b"):
            close(got[1][f"color.{c}.{k}"], layer[k], **grad_tol)


def tf32x3_linear(layer, x, compute_dtype=None):
    """`linear_apply` with the kernels' fp32 products: x = hi + lo, W = hi' +
    lo', x W ~ lo hi' + hi lo' + hi hi' (each product exact in fp32 for
    TF32 factors, summed in fp32)."""
    assert compute_dtype is None
    w = layer.w
    xh = ttrain.tf32_round(x)
    xl = ttrain.tf32_round(x - xh)
    wh = ttrain.tf32_round(w)
    wl = ttrain.tf32_round(w - wh)
    return (xl @ wh + xh @ wl) + xh @ wh + layer.b


@pytest.mark.parametrize("hidden_dim,n_hidden", [(32, 2), (256, 4)])
def test_3xtf32_products_meet_the_fp32_tolerance_against_jax(hidden_dim, n_hidden):
    jcfg, tcfg = cfgs(n_hidden=n_hidden, hidden_dim=hidden_dim)
    tree = jax.tree_util.tree_map(np.asarray, jmlp.init(jax.random.PRNGKey(7), jcfg))
    params = tmlp.from_numpy(tree, tcfg)
    o, d, ts, te, _ = inputs(6, 16, seed=3)
    want = jrender_kernel(jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
                          *map(jnp.asarray, (o, d, ts, te)), jnp.asarray(4.0),
                          jnp.asarray(2.0), tile_rays=2, interpret=True, return_weights=True)
    with mock.patch.object(tmlp, "linear_apply", tf32x3_linear):
        got = ttrain.flagship_render_reference(params, tcfg, *map(torch.as_tensor,
                                                                   (o, d, ts, te)),
                                               4.0, 2.0, return_weights=True)
    plain = ttrain.flagship_render_reference(params, tcfg, *map(torch.as_tensor, (o, d, ts, te)),
                                             4.0, 2.0, return_weights=True)
    assert not torch.equal(got[0], plain[0])  # the emulation took effect
    for a, b in zip(got, want):
        close(a, b, rtol=0.0, atol=1e-4)  # chip_smoke.TOL_FP32


def flagship_tcfg(bf16, hidden_dim=256):
    enc = dict(scale=1.0, include_identity=True)
    return tmlp.NerfMLPConfig(position_encoder=TBarf(levels=10, **enc),
                              direction_encoder=TBarf(levels=4, **enc), n_hidden=4,
                              hidden_dim=hidden_dim, n_segments=2,
                              compute_dtype=torch.bfloat16 if bf16 else None)


@pytest.mark.parametrize("bf16,n,s,want", [
    # fp32, the 64-row tile: 8192 x 128 is one ray a block in 2 tiles
    (False, 8192, 128, 23_286_775_808),
    # ragged S = 100: one ray a block, 2 tiles (64 + 36 rows), 4 halves a ray
    (False, 1000, 100, 2_229_312_000),
    # bf16, the tensor-core route: 8192 x 128 is one ray a block in 2 tiles
    (True, 8192, 128, 17_460_887_552),
    # north-star: 2 rays a block, one tile; 1023 rays leave a block with one
    (True, 8192, 32, 4_365_221_888),
    (True, 1023, 32, 545_129_600),
    # ragged S = 100: one ray a block, 2 tiles (64 + 36 rows), 4 halves a ray
    (True, 1000, 100, 1_673_712_000),
])
def test_train_workspace_bytes_is_pinned(bf16, n, s, want):
    cfg = flagship_tcfg(bf16)
    act_w, cot_w, mask_w = ttrain._train_layout(cfg, 256, 128)
    assert (act_w, cot_w, mask_w) == (2778, 2692, 2432)
    assert ttrain.tile_rows(cfg, 256, 128, train=True) == 64
    rays = max(1, 64 // s)
    halves = -(-n // rays) * -(-(rays * s) // 64) * 2
    assert ttrain._mask_halves(n, s, 64) == halves
    act_bytes = 2 if bf16 else 4
    assert ttrain.train_workspace_bytes(cfg, n, s, 256, 128) == \
        n * s * (act_w * act_bytes + (cot_w + 6) * 4) + halves * mask_w * 4 == want


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("hidden_dim,n_hidden", [(32, 2), (48, 1), (100, 2)])
def test_packed_weights_gather_equals_pack_b(bf16, hidden_dim, n_hidden):
    _, tcfg = cfgs(n_hidden=n_hidden, hidden_dim=hidden_dim, bf16=bf16)
    params = tmlp.init(torch.Generator().manual_seed(hidden_dim), tcfg)
    fwd, bwd, biases, w_density = ttrain.packed_weights(params, tcfg, "cpu", backward=True)
    D, C = hidden_dim, hidden_dim // 2
    last = 2 * n_hidden + 1
    layers = ttrain._layers(params)
    assert len(fwd) == len(bwd) == len(biases) == len(layers)
    for i, (layer, (parts, out)) in enumerate(zip(layers, ttrain._layer_parts(tcfg, D, C))):
        w = layer.w.detach()
        n_fwd = D if i == last else out
        assert torch.equal(fwd[i], ttrain.pack_b(w[:, :n_fwd], parts, [n_fwd], bf16))
        assert torch.equal(bwd[i], ttrain.pack_b(w.t(), [out], parts, bf16))
    assert torch.equal(w_density.float(), layers[last].w.detach()[:, D].to(w_density.dtype).float())


def test_render_weights_are_packed_again_only_when_the_weights_change():
    _, tcfg = cfgs(bf16=True)
    params = tmlp.init(torch.Generator().manual_seed(0), tcfg)
    first = ttrain.render_weights(params, tcfg, "cpu")
    assert ttrain.render_weights(params, tcfg, "cpu") is first
    with torch.no_grad():  # an optimizer step writes in place
        params.segments[1].layers[0].w.add_(1.0)
    second = ttrain.render_weights(params, tcfg, "cpu")
    assert second is not first
    assert not torch.equal(second[0][tcfg.n_hidden + 1], first[0][tcfg.n_hidden + 1])
    other = tmlp.init(torch.Generator().manual_seed(0), tcfg)
    assert ttrain.render_weights(other, tcfg, "cpu") is not second


@pytest.mark.parametrize("hidden,rows_fp32,rows_bf16,rows_train", [
    (256, 64, 64, 64),   # the flagship width
    (48, 64, 64, 64),
    (100, 64, 64, 64),
    (512, 32, 64, 32),
    (600, 32, 64, 32),
    (640, None, 64, 32),
    (1024, None, 32, None),
])
def test_tile_rows_follow_the_shared_memory_limit(hidden, rows_fp32, rows_bf16, rows_train):
    f32, b16 = flagship_tcfg(False, hidden), flagship_tcfg(True, hidden)
    C = hidden // 2
    assert ttrain.tile_rows(f32, hidden, C) == rows_fp32
    assert ttrain.tile_rows(b16, hidden, C) == rows_bf16
    assert ttrain.tile_rows(b16, hidden, C, train=True) == rows_train
    for cfg, train, rows in ((f32, False, rows_fp32), (b16, False, rows_bf16),
                             (b16, True, rows_train)):
        if rows is not None:
            assert ttrain.tile_smem_bytes(cfg, hidden, C, rows, train) <= ttrain.SMEM_LIMIT
        if rows != 64:  # the larger tile does not fit
            assert ttrain.tile_smem_bytes(cfg, hidden, C, 64, train) > ttrain.SMEM_LIMIT
    assert ttrain.kernels_fit(f32, train=True) == (rows_fp32 is not None)
    assert ttrain.kernels_fit(b16, train=True) == (rows_train is not None)


def test_tile_smem_bytes_is_pinned_at_the_flagship_width():
    """The sizes `TileSmem` and the kernels' fp32 arrays give in csrc/ for
    4x256 (colour 128), P = 63, Q = 27: the fp32 render tile, the bf16
    render tile and the bf16 train tile (and its 32-row tile at 512)."""
    f32, b16 = flagship_tcfg(False), flagship_tcfg(True)
    assert ttrain.tile_smem_bytes(f32, 256, 128, 64) == 220_736
    assert ttrain.tile_smem_bytes(b16, 256, 128, 64) == 122_432
    assert ttrain.tile_smem_bytes(b16, 256, 128, 64, train=True) == 217_152
    assert ttrain.tile_smem_bytes(b16, 512, 256, 32, train=True) == 190_528


@pytest.mark.parametrize("hidden,fits_render,fits_train", [
    (256, True, True), (48, True, True), (100, True, True), (1024, False, False)])
def test_configs_wider_than_the_tiles_take_the_plain_route(hidden, fits_render, fits_train):
    cfg = tbarf.BarfConfig(radiance=flagship_tcfg(False, hidden), n_training_images=2,
                           samples_per_ray_radiance=8)
    assert tbarf.can_fuse_render(cfg) == fits_render
    assert tbarf.use_fused_render(cfg, "cuda") == fits_render
    assert not tbarf.use_fused_render(cfg, "cpu")
    assert tbarf.can_fuse_train_step(cfg) == fits_train


@pytest.mark.parametrize("n,s,want", [
    (1000, 128, 4_234_752_000),  # one ray a block in 4 tiles of 32 rows
    (1000, 32, 1_058_688_000),   # one ray a block, one tile
    (999, 100, 3_322_098_576),   # 4 tiles: 32 + 32 + 32 + 4 rows
])
def test_train_workspace_bytes_at_32_row_tiles(n, s, want):
    cfg = flagship_tcfg(True, 512)
    act_w, cot_w, mask_w = ttrain._train_layout(cfg, 512, 256)
    assert ttrain.tile_rows(cfg, 512, 256, train=True) == 32
    halves = n * -(-s // 32)  # one ray a block, one mask word a column per 32 rows
    assert ttrain._mask_halves(n, s, 32) == halves
    assert ttrain.train_workspace_bytes(cfg, n, s, 512, 256) == \
        n * s * (act_w * 2 + (cot_w + 6) * 4) + halves * mask_w * 4 == want


def test_full_alphas_of_an_identity_direction_encoder_is_zero():
    cfg = tmlp.NerfMLPConfig(position_encoder=TBarf(levels=6, scale=1.0, include_identity=True),
                             direction_encoder=Identity(), n_hidden=1, hidden_dim=16)
    assert NerfMLPDef(cfg).full_alphas() == (6.0, 0.0)
    # and the model runs at those alphas
    params = NerfMLPDef(cfg).init(torch.Generator().manual_seed(0))
    x = torch.rand((5, 3), generator=torch.Generator().manual_seed(1))
    dens, rgb = tmlp.apply(params, cfg, x, x, *NerfMLPDef(cfg).full_alphas())
    assert dens.shape[0] == 5 and rgb.shape[-1] == 3 and torch.isfinite(rgb).all()


def test_bf16_linear_cpu_path_is_unchanged():
    """CPU tensors keep the rounded-fp32 product the JAX parity tests pin."""
    layer = tcommon.linear_init(torch.Generator().manual_seed(0), 24, 8)
    x = torch.randn((5, 24), generator=torch.Generator().manual_seed(1))
    got = tcommon.linear_apply(layer, x, torch.bfloat16)
    want = (x.bfloat16().float() @ layer.w.bfloat16().float() + layer.b).bfloat16()
    assert torch.equal(got, want)


class _Tf32x3Backward(torch.autograd.Function):
    """x @ W + b in fp32 whose input cotangent g W^T is the kernels' 3xTF32
    product (g = hi + lo and W = hi' + lo', each split to nearest, g W^T ~
    lo hi'^T + hi lo'^T + hi hi'^T); dW = x^T g and db in fp32, as the fp32
    tile's phase B sums them."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return x @ w + b

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gh = ttrain.tf32_round(g)
        gl = ttrain.tf32_round(g - gh)
        wh = ttrain.tf32_round(w)
        wl = ttrain.tf32_round(w - wh)
        dx = (gl @ wh.t() + gh @ wl.t()) + gh @ wh.t()
        return dx, x.t() @ g, g.sum(0)


def fp32_tile_linear(layer, x, compute_dtype=None):
    """`linear_apply` as the train kernel's fp32 tile computes it."""
    assert compute_dtype is None
    flat = x.reshape(-1, x.shape[-1])
    return _Tf32x3Backward.apply(flat, layer.w, layer.b).reshape(*x.shape[:-1], -1)


def rel_norm(a, b) -> float:
    a, b = np.asarray(a.detach().float(), np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("hidden_dim,n_hidden", [(256, 4), (48, 1), (100, 2)])
def test_fp32_tile_emulation_meets_the_fp32_tolerance_against_jax(hidden_dim, n_hidden):
    """The fp32 tile's numbers before any chip run: its forward is the plain
    fp32 one (the kernel adds in a plain fp32 GEMM's order), only g W^T runs as
    3xTF32. Held to the JAX fp32 train kernel by relative norm at
    `chip_smoke.TOL_K4_FP32`, as phase 7 holds the kernel on the card."""
    jcfg, tcfg = cfgs(n_hidden=n_hidden, hidden_dim=hidden_dim)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jmlp.init(jax.random.PRNGKey(hidden_dim), jcfg))
    params = tmlp.from_numpy(tree, tcfg)
    o, d, ts, te, targets = inputs(4, 16, seed=hidden_dim)
    a_pos, a_dir = 3.5, 1.5
    want = jtrain_kernel(jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
                         *map(jnp.asarray, (o, d, ts, te, targets)), a_pos, a_dir,
                         tile_rays=4, interpret=True)
    args = (params, tcfg, *map(torch.as_tensor, (o, d, ts, te, targets)), a_pos, a_dir)
    with mock.patch.object(tmlp, "linear_apply", fp32_tile_linear):
        got = ttrain.flagship_train_grads_reference(*args)
    plain = ttrain.flagship_train_grads_reference(*args)
    assert torch.equal(got[0], plain[0])  # the forward is the plain fp32 one
    assert not all(torch.equal(got[1][k], plain[1][k]) for k in plain[1])  # g W^T took effect
    errs = {"rgb": rel_norm(got[0], want[0]), "d_origs": rel_norm(got[2], want[2]),
            "d_dirs": rel_norm(got[3], want[3])}
    for i, seg in enumerate(want[1]["segments"]):
        for j, layer in enumerate(seg["layers"]):
            for k in ("w", "b"):
                errs[f"segments.{i}.layers.{j}.{k}"] = rel_norm(
                    got[1][f"segments.{i}.layers.{j}.{k}"], layer[k])
    for c, layer in enumerate(want[1]["color"]):
        for k in ("w", "b"):
            errs[f"color.{c}.{k}"] = rel_norm(got[1][f"color.{c}.{k}"], layer[k])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-4, (worst, errs[worst])


def test_fp32_train_tile_smem_is_pinned():
    """`train_floats` of csrc/flagship_train.cu for fp32: the tiles and rings
    of `TileSmem<false>` and 28 floats a row, 96 lanes' sums, a mask word a
    (32-row part, column) and the window. The flagship width fits a 64-row
    tile; hidden 512 a 32-row one."""
    f32 = flagship_tcfg(False)
    assert ttrain.tile_smem_bytes(f32, 256, 128, 64, train=True) == 226_752
    assert ttrain.tile_rows(f32, 256, 128, train=True) == 64
    wide = flagship_tcfg(False, 512)
    assert ttrain.tile_smem_bytes(wide, 512, 256, 64, train=True) > ttrain.SMEM_LIMIT
    assert ttrain.tile_smem_bytes(wide, 512, 256, 32, train=True) == 204_736
    assert ttrain.tile_rows(wide, 512, 256, train=True) == 32


@pytest.mark.parametrize("hidden,fp32,bf16,fused", [
    (48, ("tile_fp32", 64), ("tile_bf16", 64), True),
    (100, ("tile_fp32", 64), ("tile_bf16", 64), True),
    (256, ("tile_fp32", 64), ("tile_bf16", 64), True),   # the flagship width
    (272, ("tile_fp32", 32), ("tile_bf16", 64), True),
    (512, ("tile_fp32", 32), ("tile_bf16", 32), True),
    (620, ("tile_fp32", 32), ("tile_bf16", 32), True),
    # fp32 past the 32-row tile: no kernel, so the plain step, though the
    # render tile reaches 639
    (624, None, ("tile_bf16", 32), False),
    (639, None, ("tile_bf16", 32), False),
    (640, None, ("tile_bf16", 32), False),
    (860, None, None, False),
    (1024, None, None, False),
])
def test_train_route_by_width(hidden, fp32, bf16, fused):
    f32, b16 = flagship_tcfg(False, hidden), flagship_tcfg(True, hidden)
    C = hidden // 2
    assert ttrain.train_route(f32, hidden, C) == fp32
    assert ttrain.train_route(b16, hidden, C) == bf16
    cfg = tbarf.BarfConfig(radiance=f32, n_training_images=2, samples_per_ray_radiance=8)
    assert tbarf.can_fuse_train_step(cfg) == fused


def test_route_launches_count_each_route():
    """`train_route` names one route a compute type, counted by the one
    `launches` counter; the plain version (CPU tensors) launches nothing, so
    counts nothing."""
    assert ttrain.TRAIN_ROUTES == ("tile_bf16", "tile_fp32")
    before = ttrain.flagship_train_grads.launches
    for bf16 in (False, True):
        _, tcfg = cfgs(hidden_dim=32, bf16=bf16)
        assert ttrain.train_route(tcfg, 32, 16)[0] == ("tile_bf16" if bf16 else "tile_fp32")
        params = tmlp.init(torch.Generator().manual_seed(0), tcfg)
        o, d, ts, te, targets = inputs(2, 8, seed=0)
        ttrain.flagship_train_grads(params, tcfg, *map(torch.as_tensor, (o, d, ts, te, targets)),
                                    3.0, 1.5)
    assert ttrain.flagship_train_grads.launches == before


@pytest.mark.parametrize("n,s,rows,halves", [
    (1023, 32, 64, 1024),  # 2 rays a block: the last block's second ray is absent
    (1024, 32, 64, 1024),
    (333, 100, 64, 1332),  # one ray a block, 2 tiles of 64 rows
    (333, 100, 32, 1332),  # one ray a block, 4 tiles of 32 rows
    (255, 128, 64, 1020),  # one ray a block, 2 tiles of 64 rows
    (255, 128, 32, 1020),  # one ray a block, 4 tiles of 32 rows
])
def test_mask_halves_follow_the_route(n, s, rows, halves):
    assert ttrain._mask_halves(n, s, rows) == halves


def test_fp32_tile_workspace_packs_rays_by_the_tile():
    """fp32 at S = 32 packs two rays a 64-row tile (mask words per tile
    half); a width on the 32-row tile takes one ray a block at S = 100."""
    cfg = flagship_tcfg(False)
    act_w, cot_w, mask_w = ttrain._train_layout(cfg, 256, 128)
    assert ttrain.train_workspace_bytes(cfg, 1023, 32, 256, 128) == \
        1023 * 32 * (act_w * 4 + (cot_w + 6) * 4) + 1024 * mask_w * 4 == 727_010_816
    wide = flagship_tcfg(False, 512)
    act_w, cot_w, mask_w = ttrain._train_layout(wide, 512, 256)
    assert ttrain.train_route(wide, 512, 256) == ("tile_fp32", 32)
    assert ttrain.train_workspace_bytes(wide, 255, 100, 512, 256) == \
        255 * 100 * (act_w * 4 + (cot_w + 6) * 4) + 255 * 4 * mask_w * 4


@pytest.mark.parametrize("hidden_dim,n_hidden", [(32, 2), (48, 1), (100, 2)])
def test_fp32_tile_weights_hold_w_at_a_row_stride_of_4(hidden_dim, n_hidden):
    """The fp32 tile's forward weights: W as it is with its rows padded to a
    multiple of 4 (zeros), the last segment layer without its density
    column, which comes apart."""
    _, tcfg = cfgs(n_hidden=n_hidden, hidden_dim=hidden_dim)
    params = tmlp.init(torch.Generator().manual_seed(hidden_dim), tcfg)
    layers = ttrain._layers(params)
    last = 2 * n_hidden + 1
    fwd, w_density = ttrain._fp32_tile_weights(layers, last, hidden_dim, "cpu")
    assert len(fwd) == len(layers)
    for i, (layer, w) in enumerate(zip(layers, fwd)):
        want = layer.w.detach()[:, :hidden_dim] if i == last else layer.w.detach()
        n = want.shape[1]
        assert w.is_contiguous() and w.dtype == torch.float32
        assert w.shape == (want.shape[0], (n + 3) // 4 * 4)
        assert torch.equal(w[:, :n], want) and not w[:, n:].any()
    assert torch.equal(w_density, layers[last].w.detach()[:, hidden_dim])
