"""The design of the hash-grid backward kernel K8 (`csrc/hashgrid.cu`) on the
CPU: its int64 fixed-point table gradient, emulated by
`hashgrid.dtable_fixed_point_reference`, against `jax.grad` through the JAX
package's encoders; the emulation's bits under a permutation of the points
(the property that makes the card's atomics repeatable); the scale rule at
its worst case; the fixed point's absolute quantum; and the pinned host
array of the levels.
The kernels themselves run only on the card (`chip_smoke.py` phases 16, 17:
K8's d_table bitwise equal to this emulation and over two launches).

Inputs are made with numpy from a seed; tables N(0, 1), points random, on
grid vertices of every level and at 0 (where d|u|/du = +1, ROADMAP C).
Tolerance: d_table within 1e-5 relative norm of `jax.grad` (JAX sums in
fp32 in its own order; the emulation sums exactly and rounds once).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_experiments_tpu.ops import hashgrid as jhash
from nerf_experiments_tpu_torch.ops import hashgrid as thash

# small grids with bijective (low) and hashed (high) levels; power-of-two T
SMALL = {2: dict(n_levels=5, table_size=512, resolution_min=4, resolution_max=64),
         3: dict(n_levels=6, table_size=2048, resolution_min=4, resolution_max=64)}


def cfgs(dim, **kw):
    return jhash.HashGridConfig(dim=dim, **kw), thash.HashGridConfig(dim=dim, **kw)


def points(dim, n, seed, resolutions):
    """Random points in [0, 1), points on a vertex of every level's grid,
    and the origin."""
    rng = np.random.default_rng(seed)
    x = [rng.uniform(0.0, 1.0, size=(n, dim))]
    for res in resolutions:
        x.append(rng.integers(0, res, size=(4, dim)) / res)
    x.append(np.zeros((2, dim)))
    return np.concatenate(x).astype(np.float32)


def rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# (hash, rows) -> the JAX encoder whose table gradient K8 must give. With bf16
# rows the port rounds the gathered rows only, and d_table stays the fp32
# scatter of w g, as `encode_fused(gather_dtype=bf16)` does. `encode_rolled`
# with a bf16 compute_dtype also rounds the cotangent on its way back (its
# d_table is ~2e-3 from the fp32 scatter), so the additive hash with bf16
# rows is held to `encode_rolled` in fp32.
JAX_ENCODERS = {
    ("xor", "fp32"): lambda p, c, x: jhash.encode(p, c, x),
    ("xor", "bf16"): lambda p, c, x: jhash.encode_fused(p, c, x, gather_dtype=jnp.bfloat16),
    ("additive", "fp32"): lambda p, c, x: jhash.encode_rolled(p, c, x, compute_dtype=None),
    ("additive", "bf16"): lambda p, c, x: jhash.encode_rolled(p, c, x, compute_dtype=None),
}


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("hash", ["xor", "additive"])
@pytest.mark.parametrize("rows", ["fp32", "bf16"])
def test_fixed_point_dtable_matches_jax_grad(dim, hash, rows):
    jcfg, tcfg = cfgs(dim, **SMALL[dim])
    rng = np.random.default_rng(40 + dim)
    tbl = rng.normal(size=(jcfg.n_levels, jcfg.table_size, jcfg.n_features)).astype(np.float32)
    x = points(dim, 300, seed=50 + dim, resolutions=jcfg.level_resolutions)
    g = rng.normal(size=(x.shape[0], jcfg.output_dim)).astype(np.float32)
    encoder = JAX_ENCODERS[(hash, rows)]
    want = jax.grad(lambda t: jnp.sum(encoder({"table": t}, jcfg, jnp.asarray(x))
                                      * jnp.asarray(g)))(jnp.asarray(tbl))
    got = thash.dtable_fixed_point_reference(tcfg, torch.as_tensor(x), torch.as_tensor(g), hash)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert rel_norm(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("hash", ["xor", "additive"])
def test_fixed_point_dtable_is_bitwise_under_a_permutation_of_the_points(dim, hash):
    """The card adds the quantised contributions with atomics in no fixed
    order; integer sums make that order irrelevant. Here the points (and
    their cotangents) come in another order, and d_table keeps its bits,
    while an fp32 scatter in the two orders does not."""
    _, tcfg = cfgs(dim, **SMALL[dim])
    rng = np.random.default_rng(60 + dim)
    x = torch.as_tensor(points(dim, 2000, seed=61 + dim, resolutions=tcfg.level_resolutions))
    g = torch.as_tensor(rng.normal(size=(x.shape[0], tcfg.output_dim)).astype(np.float32))
    perm = torch.as_tensor(rng.permutation(x.shape[0]))
    a = thash.dtable_fixed_point_reference(tcfg, x, g, hash)
    b = thash.dtable_fixed_point_reference(tcfg, x[perm], g[perm], hash)
    assert torch.equal(a, b)
    plain = []
    for order in (torch.arange(x.shape[0]), perm):
        table = torch.zeros((tcfg.n_levels, tcfg.table_size, tcfg.n_features),
                            requires_grad=True)
        enc = thash.encode_reference(table, tcfg, x[order], hash)
        plain.append(torch.autograd.grad(enc, table, g[order])[0])
    assert not torch.equal(plain[0], plain[1])
    assert rel_norm(a.numpy(), plain[0].numpy()) <= 1e-6


WORST_MAX_ABS_G = [1.0, 0.7, float(np.nextafter(np.float32(1), np.float32(0))),
                   float(np.finfo(np.float32).max), float(np.finfo(np.float32).tiny), 1e-45,
                   1e-30, 3.0e12]


@pytest.mark.parametrize("max_abs_g", WORST_MAX_ABS_G)
@pytest.mark.parametrize("n", [1, 3, 8192, 524_288, 2**24 + 1])
@pytest.mark.parametrize("dim", [2, 3])
def test_fixed_point_shift_never_overflows(max_abs_g, n, dim):
    """The worst case of a row: every point's 2^d corners in that one row,
    every w = 1 and every |g| = max|g|. The first word is rounded from
    max|g| 2^s in fp32, as the kernel and the emulation do, and 2^d n of them
    must stay inside int64, with either sign; so must 2^d n of each later
    word, each at most 2^(K-1) (a remainder of 1/2 times 2^K). Where the
    shift is not clamped it is the largest that does (at s + 1 the bound 2^d
    n 2^(e+s+1) reaches 2^63), and a term keeps 2^-(62 - d - ceil(log2 n))
    of max|g| in its first word; K is the largest shift between words that
    stays inside int64; the words reach 2^-149 (fp32's smallest step) unless
    there are four."""
    s = thash.fixed_point_shift(max_abs_g, n, dim)
    q = round(float(np.float32(max_abs_g) * np.float32(2.0 ** s)))
    assert 0 <= 2 ** dim * n * q <= 2**63 - 1
    k = thash.fixed_point_lo_shift(n, dim)
    assert 2 ** dim * n * 2 ** (k - 1) <= 2**63 - 1
    assert 2 ** dim * 2 ** (n - 1).bit_length() * 2 ** k >= 2**63
    assert 2.0 ** k < float(np.finfo(np.float32).max)  # 2^K is an fp32 scale
    words = thash.fixed_point_words(s, k)
    assert 2 <= words <= thash.MAX_WORDS
    assert s + (words - 1) * k >= 149 or words == thash.MAX_WORDS
    lo, hi = thash.SHIFT_RANGE
    if lo < s < hi:
        e = math.frexp(max_abs_g)[1]
        assert 2 ** dim * 2 ** (n - 1).bit_length() * 2.0 ** (e + s + 1) >= 2.0**63
        assert q >= 2.0 ** (61 - dim - (n - 1).bit_length())


def test_fixed_point_worst_row_in_the_emulation():
    """n points on one grid vertex at every level (x = 0, w = 1 on one corner)
    with g at its max everywhere: the emulation's int64 sum of the row holds
    n max|g| exactly, with either sign, and every other row is 0."""
    _, tcfg = cfgs(3, **SMALL[3])
    n = 4096
    x = torch.zeros((n, 3))
    for sign in (1.0, -1.0):
        g = torch.full((n, tcfg.output_dim), sign * 3.5)
        d_table = thash.dtable_fixed_point_reference(tcfg, x, g)
        assert torch.all(d_table[:, 0] == sign * 3.5 * n)
        assert torch.count_nonzero(d_table[:, 1:]) == 0


def test_fixed_point_dtable_of_a_non_finite_cotangent_is_nan():
    """The trainer skips a step whose gradients are not finite; a NaN or inf
    in g must reach d_table (the kernel then writes NaN everywhere)."""
    _, tcfg = cfgs(2, **SMALL[2])
    x = torch.as_tensor(points(2, 50, seed=3, resolutions=tcfg.level_resolutions))
    for bad in (float("nan"), float("inf")):
        g = torch.ones((x.shape[0], tcfg.output_dim))
        g[5, 2] = bad
        assert torch.isnan(thash.dtable_fixed_point_reference(tcfg, x, g)).all()


def exact_dtable(cfg, x, g, hash="xor"):
    """(the sums of K8's fp32 terms in float64, the number of terms and the
    sum of |term| of each element)."""
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features
    exact = torch.zeros((L * T, F), dtype=torch.float64)
    terms = torch.zeros((L * T, 1), dtype=torch.float64)
    mass = torch.zeros((L * T, F), dtype=torch.float64)
    for rows, c in thash.dtable_terms(cfg, x, g, hash):
        exact.index_add_(0, rows, c.double())
        terms.index_add_(0, rows, torch.ones((rows.shape[0], 1), dtype=torch.float64))
        mass.index_add_(0, rows, c.double().abs())
    return exact, terms, mass


def one_word_dtable(cfg, x, g, hash="xor"):
    """The table gradient with the first word alone (each term rint(c 2^s),
    summed in int64, times 2^-s): K8 before its later words."""
    s = thash.fixed_point_shift(float(g.abs().max()), x.shape[0], cfg.dim)
    acc = torch.zeros((cfg.n_levels * cfg.table_size, cfg.n_features), dtype=torch.int64)
    for rows, c in thash.dtable_terms(cfg, x, g, hash):
        acc.index_add_(0, rows, torch.round((c * np.float32(2.0 ** s)).double()).long())
    return (acc.double() * 2.0 ** -s).float()


def quantum_bound(cfg, x, g, exact, terms, mass):
    """Each term of an element is within half its last word's quantum
    2^-(s+(W-1)K) of its words, so the element is within (its terms) x
    2^-(s+(W-1)K+1) of the exact sum, plus fp32's last rounding, plus the
    float64 reference's own rounding (2^-46 of the sum of |terms|)."""
    n = x.shape[0]
    s = thash.fixed_point_shift(float(g.abs().max()), n, cfg.dim)
    k = thash.fixed_point_lo_shift(n, cfg.dim)
    last = s + (thash.fixed_point_words(s, k) - 1) * k
    return (terms * 2.0 ** -(last + 1) * (1 + 2.0**-22) + exact.abs() * 2.0**-23
            + mass * 2.0**-46)


@pytest.mark.parametrize("dim", [2, 3])
def test_fixed_point_dtable_error_is_half_a_quantum_a_term(dim):
    """K8's precision limit, on its emulation: each term is cut into words
    down to a quantum of 2^-(s+(W-1)K), here below fp32's smallest step, so
    an element of d_table is its exact sum, rounded once (within its terms x
    2^-(s+(W-1)K+1) of the exact sum of its fp32 terms, plus fp32's last
    rounding). With level 0's cotangent 1e-16 of the rest, every term of
    level 0 lies below the first word's half quantum 2^-(s+1): the first
    word alone gives 0 there, where the plain fp32 scatter keeps it, and the
    words keep every element the exact sum has."""
    _, tcfg = cfgs(dim, **SMALL[dim])
    rng = np.random.default_rng(70 + dim)
    x = torch.as_tensor(points(dim, 2000, seed=71 + dim, resolutions=tcfg.level_resolutions))
    g = rng.normal(size=(x.shape[0], tcfg.output_dim)).astype(np.float32)
    g[:, :tcfg.n_features] *= np.float32(1e-16)
    g = torch.as_tensor(g)
    L, T, F = tcfg.n_levels, tcfg.table_size, tcfg.n_features
    s = thash.fixed_point_shift(float(g.abs().max()), x.shape[0], dim)
    k = thash.fixed_point_lo_shift(x.shape[0], dim)
    assert s + (thash.fixed_point_words(s, k) - 1) * k >= 149
    exact, terms, mass = exact_dtable(tcfg, x, g)
    got = thash.dtable_fixed_point_reference(tcfg, x, g).reshape(L * T, F).double()
    assert torch.all((got - exact).abs() <= quantum_bound(tcfg, x, g, exact, terms, mass))
    assert torch.count_nonzero(one_word_dtable(tcfg, x, g)[:T]) == 0
    assert torch.count_nonzero(exact[:T]) > 0
    assert torch.equal(got != 0, exact != 0)
    table = torch.zeros((L, T, F), requires_grad=True)
    plain = torch.autograd.grad(thash.encode_reference(table, tcfg, x), table, g)[0]
    assert torch.count_nonzero(plain[0]) == torch.count_nonzero(exact[:T])


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("hash", ["xor", "additive"])
def test_fixed_point_keeps_small_table_gradients(dim, hash):
    """ROADMAP C4: a cotangent over 30 decades (each g element N(0, 1) times
    10^U(-30, 0)) on a table whose fine levels take a few terms a row, as a
    trained INGP step's cotangent and table are (its smallest nonzero
    elements lie near 1e-26 max|g|). The first word alone gives 0 for
    elements that `jax.grad` through the JAX encoding gives as nonzero; the
    emulation of K8 keeps every one of them, and every element within its
    bound of the exact float64 sum of its fp32 terms (`quantum_bound`)."""
    grid = dict(n_levels=6, table_size=2**14, resolution_min=4, resolution_max=256)
    jcfg, tcfg = cfgs(dim, **grid)
    rng = np.random.default_rng(80 + dim)
    x = points(dim, 500, seed=81 + dim, resolutions=jcfg.level_resolutions)
    g = (rng.normal(size=(x.shape[0], jcfg.output_dim))
         * 10.0 ** rng.uniform(-30.0, 0.0, size=(x.shape[0], jcfg.output_dim)))
    g = g.astype(np.float32)
    tbl = np.zeros((jcfg.n_levels, jcfg.table_size, jcfg.n_features), np.float32)
    encoder = JAX_ENCODERS[(hash, "fp32")]
    ref = jax.grad(lambda t: jnp.sum(encoder({"table": t}, jcfg, jnp.asarray(x))
                                     * jnp.asarray(g)))(jnp.asarray(tbl))
    ref = torch.as_tensor(np.array(ref)).reshape(-1, jcfg.n_features)
    xt, gt = torch.as_tensor(x), torch.as_tensor(g)
    got = thash.dtable_fixed_point_reference(tcfg, xt, gt, hash).reshape(ref.shape)
    kept = ref != 0
    assert torch.count_nonzero(one_word_dtable(tcfg, xt, gt, hash)[kept] == 0) > 0
    assert torch.count_nonzero(got[kept] == 0) == 0
    exact, terms, mass = exact_dtable(tcfg, xt, gt, hash)
    bound = quantum_bound(tcfg, xt, gt, exact, terms, mass)
    assert torch.all((got.double() - exact).abs() <= bound)


def test_kernel_level_info_is_pinned():
    """The host array the kernels read (`make_levels` in csrc/hashgrid.cu):
    [res, t_eff, bijective] a level, then three primes. At run_3d_ingp's grid
    levels 0-3 are bijective ((res + 1)^3 rows) and the rest hashed over T;
    an odd table size packs the same way."""
    info = thash.level_info(thash.HashGridConfig(dim=3))
    assert len(info) == 3 * 16 + 3
    assert info[:15] == [16, 4913, 1, 20, 9261, 1, 25, 17576, 1, 32, 35937, 1, 40, 65536, 0]
    assert info[-6:] == [512, 65536, 0, 1, 2654435761, 805459861]
    odd = thash.level_info(thash.HashGridConfig(dim=3, table_size=2**16 - 1))
    assert odd[:15] == info[:12] + [40, 65535, 0]
    two = thash.level_info(thash.HashGridConfig(dim=2, resolution_max=2048, primes=(1, 7)))
    assert two[:3] == [16, 289, 1] and two[-3:] == [1, 7, 0]
