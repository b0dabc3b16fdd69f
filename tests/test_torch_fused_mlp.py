"""The port's fused MLP chain (`ops/fused_mlp.py`) and the fused-chain model
plug (`systems/barf.py:FusedNerfMLPDef`) against the JAX package on the CPU.

On a CPU tensor `fused_chain` is its plain version; it is held to the JAX
Pallas chain `fused_chain(..., interpret=True)` in the forward and to
`jax.vjp` of the JAX *plain* chain (the kernels' arithmetic written in jnp)
in the backward: the JAX package's own custom VJP returns each db as (D,)
for a (1, D) primal and raises under `jax.grad` (pinned below, so that a fix
shows up). Inputs are made with numpy from a seed. Tolerances: fp32 rtol
1e-5 / atol 1e-5 (forward) and 1e-4 (gradients: summation order through a
chain); bf16 atol 2e-2 in the forward and relative norm 2e-2 in the
gradients (both round every product's operands to bf16; JAX's autodiff also
rounds the cotangents of the bf16-stored activations).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_experiments_tpu.encodings import fourier as jfourier
from nerf_experiments_tpu.models import nerf_mlp as jmlp
from nerf_experiments_tpu.ops import fused_mlp as jfused
from nerf_experiments_tpu.systems import barf as jbarf
from nerf_experiments_tpu_torch.encodings import fourier as tfourier
from nerf_experiments_tpu_torch.models import nerf_mlp as tmlp
from nerf_experiments_tpu_torch.ops import fused_mlp as tfused
from nerf_experiments_tpu_torch.systems import barf as tbarf

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FWD = {False: dict(rtol=1e-5, atol=1e-5), True: dict(rtol=0.0, atol=2e-2)}
GRAD_FP32 = dict(rtol=1e-4, atol=1e-5)
GRAD_BF16_REL = 2e-2


def close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port.detach()), np.asarray(ref, np.float32), **tol)


def rel_norm(port, ref) -> float:
    port, ref = np.asarray(port.detach(), np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(port - ref) / max(np.linalg.norm(ref), 1e-30))


def chain(dims, seed=0):
    """Layers as numpy dicts (the JAX package's layout) and the port's."""
    rng = np.random.default_rng(seed)
    layers = [{"w": (rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32),
               "b": (rng.normal(size=(b,)) * 0.1).astype(np.float32)}
              for a, b in zip(dims[:-1], dims[1:])]
    port = [tmlp.Dense(torch.as_tensor(l["w"]), torch.as_tensor(l["b"])) for l in layers]
    return layers, port


def jax_plain_chain(x, layers, compute_dtype):
    """The TPU kernels' arithmetic in plain jnp (`_fwd_kernel`), differentiable."""
    h = x
    for i, layer in enumerate(layers):
        h = jfused._dot(h, layer["w"], compute_dtype) + layer["b"]
        if i < len(layers) - 1:
            h = jax.nn.relu(h)
            if compute_dtype is not None:
                h = h.astype(compute_dtype)
    return h.astype(jnp.float32)


CHAINS = {
    "segment": (12, 32, 32, 17),
    "wide_in": (40, 24, 8),
    "one_layer": (9, 3),
}


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("name,rows", [("segment", 37), ("wide_in", 600), ("one_layer", 5)])
def test_fused_chain_matches_jax_kernel(name, rows, bf16):
    """Forward against the JAX Pallas chain in interpret mode; 600 rows span
    two of its 512-row tiles with a ragged second one."""
    dims = CHAINS[name]
    layers, port = chain(dims)
    x = np.random.default_rng(1).normal(size=(rows, dims[0])).astype(np.float32)
    want = jfused.fused_chain(jnp.asarray(x), layers,
                              compute_dtype=jnp.bfloat16 if bf16 else None, interpret=True)
    got = tfused.fused_chain(torch.as_tensor(x), port, torch.bfloat16 if bf16 else None)
    assert got.dtype == torch.float32 and got.shape == (rows, dims[-1])
    close(got, want, **FWD[bf16])


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("name", sorted(CHAINS))
def test_fused_chain_gradients_match_jax_plain_chain(name, bf16):
    """dx and every dW / db against `jax.vjp` of the plain JAX chain, for a
    random output cotangent."""
    dims = CHAINS[name]
    layers, port = chain(dims, seed=2)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(29, dims[0])).astype(np.float32)
    g = rng.normal(size=(29, dims[-1])).astype(np.float32)
    dtype = jnp.bfloat16 if bf16 else None
    jlayers = jax.tree_util.tree_map(jnp.asarray, layers)
    _, vjp = jax.vjp(lambda x, ls: jax_plain_chain(x, ls, dtype), jnp.asarray(x), jlayers)
    jdx, jgrads = vjp(jnp.asarray(g))

    xt = torch.as_tensor(x).requires_grad_(True)
    for layer in port:
        layer.w.requires_grad_(True)
        layer.b.requires_grad_(True)
    y = tfused.fused_chain(xt, port, torch.bfloat16 if bf16 else None)
    y.backward(torch.as_tensor(g))
    pairs = [(xt.grad, jdx)] + [(getattr(p, k).grad, jg[k]) for p, jg in zip(port, jgrads)
                                for k in ("w", "b")]
    for got, want in pairs:
        if bf16:
            assert rel_norm(got, want) <= GRAD_BF16_REL
        else:
            close(got, want, **GRAD_FP32)


def test_jax_fused_chain_vjp_raises():
    """The JAX package's custom VJP hands back db as (D,) for the (1, D)
    primal it was given (`ops/fused_mlp.py:205` against `:227`), so
    `jax.grad` through `fused_chain` raises: a fault of the reference, which
    the port does not copy. If this test fails, the reference was fixed and
    the gradient tests above can hold the port to it directly."""
    layers, _ = chain(CHAINS["wide_in"], seed=4)
    x = jnp.asarray(np.random.default_rng(5).normal(size=(8, 40)).astype(np.float32))
    loss = lambda ls: jnp.sum(jfused.fused_chain(x, ls, interpret=True))
    with pytest.raises(Exception, match="Custom VJP bwd rule must produce an output"):
        jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray, layers))


def test_bf16_backward_rounds_the_cotangent_only_inside_its_products():
    """The plain backward (torch autograd) equals the kernel's recipe written
    out: g <- (round(g) round(W)^T) * (a > 0), dW = round(a)^T round(g), db =
    sum g, the running g kept in fp32."""
    dims = CHAINS["segment"]
    layers, port = chain(dims, seed=6)
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.normal(size=(21, dims[0])).astype(np.float32))
    g = torch.as_tensor(rng.normal(size=(21, dims[-1])).astype(np.float32))
    dx, dws, dbs = tfused.fused_chain_bwd_reference(x, port, g, torch.bfloat16)

    r = lambda t: t.to(torch.bfloat16).float()
    acts = [r(x)]
    for layer in port[:-1]:
        acts.append(r(torch.relu(acts[-1] @ r(layer.w) + layer.b)))
    cot = g
    for i in range(len(port) - 1, -1, -1):
        torch.testing.assert_close(dws[i], acts[i].t() @ r(cot), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(dbs[i], cot.sum(0), rtol=1e-5, atol=1e-5)
        cot = r(cot) @ r(port[i].w).t()
        if i > 0:
            cot = cot * (acts[i] > 0)
    torch.testing.assert_close(dx, cot, rtol=1e-5, atol=1e-5)


def test_fused_chain_autograd_function_wiring(monkeypatch):
    """`FusedChain` (the kernels' autograd function) hands each gradient to
    its tensor: driven on the CPU with the kernel wrappers replaced by the
    plain versions."""
    def fwd(x, layers, bf16, packed=None):
        tfused.fused_mlp_fwd_cuda.launches += 1
        return tfused.fused_chain_reference(x, layers, torch.bfloat16 if bf16 else None)

    def bwd(x, layers, g, bf16, packed=None):
        tfused.fused_mlp_bwd_cuda.launches += 1
        return tfused.fused_chain_bwd_reference(x, layers, g, torch.bfloat16 if bf16 else None)

    monkeypatch.setattr(tfused, "fused_mlp_fwd_cuda", fwd)
    monkeypatch.setattr(tfused, "fused_mlp_bwd_cuda", bwd)
    fwd.launches = bwd.launches = 0
    dims = CHAINS["segment"]
    _, port = chain(dims, seed=8)
    wb = [t.requires_grad_(True) for layer in port for t in (layer.w, layer.b)]
    x = torch.randn((11, dims[0]), generator=torch.Generator().manual_seed(9),
                    requires_grad=True)
    y = tfused.FusedChain.apply(x, False, True, *wb)
    grads = torch.autograd.grad(y.square().sum(), [x, *wb])
    want = torch.autograd.grad(tfused.fused_chain_reference(x, port).square().sum(), [x, *wb])
    assert fwd.launches == 1 and bwd.launches == 1
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_fused_chain_refuses_other_compute_types_and_widths():
    _, port = chain(CHAINS["segment"])
    with pytest.raises(ValueError):
        tfused.fused_chain(torch.zeros((2, 12)), port, torch.float16)
    with pytest.raises(ValueError, match="width"):
        tfused._dims(torch.zeros((2, 11)), port)


def test_bwd_workspace_bytes_counts_inputs_and_cotangents():
    dims = (63, 256, 256, 257)
    assert tfused.bwd_workspace_bytes(10, dims, False) == 10 * 4 * (575 + 769)
    assert tfused.bwd_workspace_bytes(10, dims, True) == 10 * (2 * 575 + 4 * 769)


# ---------------------------------------------------------------- FusedNerfMLPDef


def mlp_configs(encoder, bf16=False, **kw):
    """The same small NerfMLP config in both packages, with BARF or
    integrated (Mip) position encodings."""
    arch = dict(n_hidden=2, hidden_dim=32, n_segments=2, delayed_direction=True,
                delayed_density=False)
    arch.update(kw)
    out = []
    for enc, dtype in ((jfourier, jnp.bfloat16), (tfourier, torch.bfloat16)):
        if encoder == "barf":
            pos = enc.Barf(levels=4, scale=1.0, include_identity=True)
        else:
            pos = enc.Integrated(levels=4, scale=1.0, include_identity=True)
        dir_enc = enc.Fourier(levels=2, scale=1.0)
        mod = jmlp if enc is jfourier else tmlp
        out.append(mod.NerfMLPConfig(position_encoder=pos, direction_encoder=dir_enc,
                                     compute_dtype=dtype if bf16 else None, **arch))
    return out


def samples(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    pos = (rng.normal(size=(n, 3)) * 0.5).astype(np.float32)
    ts = rng.uniform(2.0, 5.0, size=(n, 1)).astype(np.float32)
    te = (ts + rng.uniform(0.05, 0.2, size=(n, 1))).astype(np.float32)
    pw = np.full((n, 1), 2e-3, np.float32)
    return pos, d, pw, ts, te


def named(tree):
    out = {}
    for i, seg in enumerate(tree["segments"]):
        for j, layer in enumerate(seg["layers"]):
            out.update({f"segments.{i}.layers.{j}.{k}": layer[k] for k in ("w", "b")})
    for c, layer in enumerate(tree["color"]):
        out.update({f"color.{c}.{k}": layer[k] for k in ("w", "b")})
    return out


PLUG_CASES = {
    "barf": dict(encoder="barf"),
    "ipe": dict(encoder="ipe"),
    "ipe_sigma": dict(encoder="ipe", pixel_width_sigma=3.0),
    "naive": dict(encoder="barf", n_segments=3, delayed_direction=False,
                  delayed_density=True),
    "ipe_bf16": dict(encoder="ipe", bf16=True),
}


@pytest.mark.parametrize("case", sorted(PLUG_CASES))
def test_fused_plug_matches_jax(case):
    """`FusedNerfMLPDef.apply` against the JAX `FusedNerfMLPDef` (Pallas
    chains in interpret mode) and the JAX `NerfMLPDef` in the forward, and
    against `jax.vjp` of the JAX `NerfMLPDef` in the backward (density and
    rgb cotangents; every parameter and the positions)."""
    kw = dict(PLUG_CASES[case])
    sigma = kw.pop("pixel_width_sigma", 0.0)
    bf16 = kw.get("bf16", False)
    jcfg, tcfg = mlp_configs(**kw)
    tree = jax.tree_util.tree_map(np.asarray, jmlp.init(jax.random.PRNGKey(0), jcfg))
    plug = tbarf.FusedNerfMLPDef(tcfg)
    params = plug.from_numpy(tree)
    pos, d, pw, ts, te = samples(40, 1)
    alphas = (2.5, 1.5)
    jargs = [jnp.asarray(a) for a in (d, pw, ts, te)]
    targs = [torch.as_tensor(a) for a in (d, pw, ts, te)]

    for jdef in (jbarf.FusedNerfMLPDef(jcfg, interpret=True), jbarf.NerfMLPDef(jcfg)):
        want = jdef.apply(tree, jnp.asarray(pos), *jargs, *alphas, pixel_width_sigma=sigma)
        got = plug.apply(params, torch.as_tensor(pos), *targs, *alphas, pixel_width_sigma=sigma)
        for a, b in zip(got, want):
            close(a, b, **FWD[bf16])

    rng = np.random.default_rng(2)
    cd, crgb = rng.normal(size=(40,)).astype(np.float32), rng.normal(size=(40, 3)).astype(
        np.float32)
    fn = lambda p, x: jbarf.NerfMLPDef(jcfg).apply(p, x, *jargs, *alphas,
                                                   pixel_width_sigma=sigma)
    _, vjp = jax.vjp(fn, jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(pos))
    jtree, jpos = vjp((jnp.asarray(cd), jnp.asarray(crgb)))
    post = torch.as_tensor(pos).requires_grad_(True)
    density, rgb = plug.apply(params, post, *targs, *alphas, pixel_width_sigma=sigma)
    torch.autograd.backward([density, rgb], [torch.as_tensor(cd), torch.as_tensor(crgb)])
    want = dict(named(jtree), pos=jpos)
    got = dict(params.named_parameters(), pos=post)
    assert set(got) == set(want)
    for k, v in got.items():
        if bf16:
            assert rel_norm(v.grad, want[k]) <= GRAD_BF16_REL, k
        else:
            close(v.grad, want[k], **GRAD_FP32, err_msg=k)


def test_fused_plug_shares_the_plain_plugs_interface():
    """Same init, parameter group and alphas as `NerfMLPDef`; `model_def`
    keeps the plug as it is."""
    _, tcfg = mlp_configs("barf")
    plain, fused = tbarf.NerfMLPDef(tcfg), tbarf.FusedNerfMLPDef(tcfg)
    a = plain.init(torch.Generator().manual_seed(3))
    b = fused.init(torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert fused.param_group == plain.param_group
    assert fused.alphas_at(0.3) == plain.alphas_at(0.3)
    assert fused.full_alphas() == plain.full_alphas()
    assert tbarf.model_def(fused) is fused
    cfg = dataclasses.replace(tcfg, position_encoder=tfourier.Integrated(levels=4, scale=1.0))
    assert tbarf.FusedNerfMLPDef(cfg).alphas_at(0.3) == (0.0, 0.0)
