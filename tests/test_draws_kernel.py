"""The Pallas-Triton draw kernels (interpret mode) against their plain
references: `block_draws` vs the per-SNP XLA scan `_snp_scan_step`, and
`mme_block_draws` vs the MME site scan.

Both sides are f32 with different summation orders, so a discrete mixture
draw sitting on a threshold can flip: spike/slab/fold indicators must agree
on >= 99% of draws, |dg| within 5e-5 max|g| where they agree.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hibayes_tpu.engine import gibbs as G
from hibayes_tpu.ops import blockgibbs as BG
from tests.oracle import guarded_draws_oracle

MODELS = ["BayesRR", "BayesA", "BayesBpi", "BayesCpi", "BayesL", "BayesR"]


def make_block(model, K, B=128, n=256, seed=0, guard=False, vary=1.0):
    """One block of B SNPs for K chains: spec, per-chain consts and the
    per-SNP inputs the sweep hands to the draws."""
    rng = np.random.default_rng(seed)
    X = rng.binomial(2, 0.3, size=(n, B)).astype(np.float64)
    X[:, 5] = 1.0  # a monomorphic SNP (vx == 0, inactive)
    W = X.T @ X
    xpx = np.diag(W).copy()
    vx = X.var(axis=0, ddof=1)
    if model == "BayesR":
        nf, pi = 4, np.array([0.95, 0.02, 0.02, 0.01])
        fold = np.array([0.0, 1e-4, 1e-3, 1e-2])
    else:
        nf, pi, fold = 2, np.array([0.9, 0.1]), np.zeros(2)
    spec = G.GibbsSpec(
        model=model, n=n, m=B, m_pad=B, block=B, nc=0, nlevels=(), n_fold=nf,
        niter=10, nburn=5, thin=1, nvar0=1, s2varg=0.002, dfvara=4.0,
        reject_guard=guard, vary=vary)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    varg = 0.01 * (1.0 + rng.random(K))
    consts = {
        "varg": f32(varg),
        "s2varg_df": f32(np.full(K, spec.s2varg * spec.dfvara)),
        "logpi": f32(np.log(np.tile(pi, (K, 1)))),
        "lambda2": f32(np.full(K, 50.0)),
        "vara_fold": f32(varg[:, None] * 200.0 * fold[None, :]),
        "fold": f32(np.tile(fold, (K, 1))),
        "vary": f32(np.full(K, vary)),
        "reject_key": jax.random.split(jax.random.PRNGKey(seed), K),
    }
    per_chain = {
        "vei": f32(np.tile(0.5 + rng.random((K, 1)), (1, B))),
        "g": f32(rng.normal(0, 0.05, (K, B))),
        "z": f32(rng.normal(size=(K, B))),
        "u": f32(rng.random((K, B, nf)) if model == "BayesR"
                 else rng.random((K, B))),
        "chi": f32(rng.chisquare(5.0, (K, B))),
        "z2": f32(rng.normal(size=(K, B))),
        "vargL": f32(0.01 + 0.01 * rng.random((K, B))),
        "r0": f32(X.T @ rng.normal(0, 1.0, (n, K))),
    }
    shared = {"W": f32(W), "xpx": f32(xpx), "vx": f32(vx)}
    return spec, consts, per_chain, shared


def scan_draws(spec, consts, pc, sh):
    """Reference: the engine's per-SNP XLA scan, vmapped over chains."""
    B = spec.block

    def one(c, vei, g, z, u, chi, z2, vargL, r0):
        _, (g_new, track, _) = jax.lax.scan(
            functools.partial(G._snp_scan_step, spec, c),
            (r0, jnp.zeros((), jnp.float32), jnp.zeros((), jnp.float32)),
            (jnp.arange(B), jnp.arange(B), sh["W"], sh["xpx"], sh["vx"], vei,
             g, z, u, chi, z2, vargL))
        return g - g_new, track

    return jax.vmap(one)(consts, pc["vei"], pc["g"], pc["z"], pc["u"],
                         pc["chi"], pc["z2"], pc["vargL"], pc["r0"].T)


def packed_rows(spec, consts, pc, sh, z_retry=None):
    def pack(c, vei, g, z, u, chi, vargL, zr):
        c = dict(c, vargL_vec=vargL)
        P = BG._pack_rows(spec, c, sh["xpx"], sh["vx"], vei, g, z, u, chi)
        if zr is None:
            return P
        return jnp.concatenate(
            [P, BG._pack_retry_rows(spec, c, sh["xpx"], sh["vx"], vei, zr)])

    return jax.vmap(pack)(consts, pc["vei"], pc["g"], pc["z"], pc["u"],
                          pc["chi"], pc["vargL"], z_retry)  # (K, R, B)


def kernel_draws(spec, consts, pc, sh, z_retry=None):
    P = packed_rows(spec, consts, pc, sh, z_retry)
    P_b = BG.to_block_layout(P, 1, spec.block)[0]
    dg, track = BG.block_draws(spec, P_b, sh["W"], pc["r0"])
    return dg.T, track.T.astype(jnp.int32), P


def assert_draws_agree(dg_ref, tr_ref, dg, tr, g_scale):
    agree = np.asarray(tr_ref) == np.asarray(tr)
    assert agree.mean() >= 0.99, f"indicator flips {100 * (1 - agree.mean()):.2f}%"
    np.testing.assert_allclose(np.asarray(dg)[agree], np.asarray(dg_ref)[agree],
                               rtol=0, atol=5e-5 * g_scale)


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("model", MODELS)
def test_block_draws_match_scan(model, K, interpret_kernels):
    spec, consts, pc, sh = make_block(model, K, seed=MODELS.index(model) + K)
    dg_ref, tr_ref = scan_draws(spec, consts, pc, sh)
    dg, tr, _ = kernel_draws(spec, consts, pc, sh)
    assert dg.shape == (K, spec.block)
    g_new = np.asarray(pc["g"]) - np.asarray(dg_ref)
    assert_draws_agree(dg_ref, tr_ref, dg, tr, np.abs(g_new).max() + 1e-12)
    if model in ("BayesCpi", "BayesBpi", "BayesR"):
        assert np.asarray(tr).any(), "no slab draw: the mixture is untested"


@pytest.mark.parametrize("model", ["BayesCpi", "BayesR"])
def test_block_draws_rejection_guard(model, interpret_kernels):
    """The guarded kernel (retry rows appended) against a sequential f64
    NumPy transcription of the same retry rule, with vary small enough that
    rejections fire."""
    spec, consts, pc, sh = make_block(model, 4, seed=21, guard=True,
                                      vary=2e-3)
    z_retry = jax.random.normal(jax.random.PRNGKey(3), (4, BG.N_RETRY, 128),
                                jnp.float32)
    dg, tr, P = kernel_draws(spec, consts, pc, sh, z_retry)
    dg_ref, tr_ref, n_rej = guarded_draws_oracle(
        spec, np.asarray(P), np.asarray(sh["W"]), np.asarray(pc["r0"]).T)
    assert n_rej > 0, "guard never fired"
    g_new = np.asarray(pc["g"]) - dg_ref
    assert_draws_agree(dg_ref, tr_ref, dg, tr, np.abs(g_new).max() + 1e-12)


def test_block_draws_layout_pads_chains():
    """to_block_layout pads chains to whole tiles; R is kept as is."""
    P = jnp.ones((3, 5, 256))
    Pb = BG.to_block_layout(P, 2, 128)
    assert Pb.shape == (2, 128, 5, BG.CHAIN_TILE)
    assert float(Pb[..., 3:].sum()) == 0.0
    assert float(Pb[..., :3].sum()) == 3 * 5 * 256


@pytest.mark.parametrize("block,dtype,ok", [
    (128, jnp.float32, True), (16, jnp.float32, True),
    (96, jnp.float32, False), (8, jnp.float32, False),
    (128, jnp.float64, False),
])
def test_draws_supported(block, dtype, ok):
    spec = G.GibbsSpec(model="BayesCpi", n=8, m=block, m_pad=block,
                       block=block, nc=0, nlevels=(), n_fold=2, niter=2,
                       nburn=1, thin=1, nvar0=0)
    assert BG.draws_supported(spec, dtype) is ok


def mme_problem(T=128, seed=9):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(T, T)) * 0.05
    W = A @ A.T + np.diag(1.0 + rng.random(T))
    W[-3:, :] = 0.0
    W[:, -3:] = 0.0  # zero-padded tail sites
    d = np.diag(W)
    ok = d > 0
    invd = np.where(ok, 1.0 / np.where(ok, d, 1.0), 0.0)
    noise = np.where(ok, rng.normal(size=T) * np.sqrt(invd), 0.0)
    r0 = rng.normal(size=T)
    return W, r0, invd, noise


def mme_scan(W, r0, invd, noise):
    """Plain site scan: dx_j = (r0_j - sum_{i<j} W[j,i] dx_i) invd_j + noise_j."""
    def site(r, xs):
        j, wcol, iv, nz = xs
        dx = r[j] * iv + nz
        return r - dx * wcol, dx

    _, dx = jax.lax.scan(site, r0, (jnp.arange(W.shape[0]), W.T, invd, noise))
    return dx


def test_mme_block_draws_match_site_scan(interpret_kernels):
    W, r0, invd, noise = (jnp.asarray(a, jnp.float32) for a in mme_problem())
    dx_ref = np.asarray(mme_scan(W, r0, invd, noise))
    dx = np.asarray(BG.mme_block_draws(W, r0, invd, noise))
    np.testing.assert_allclose(dx, dx_ref, rtol=0,
                               atol=1e-5 * np.abs(dx_ref).max())
    assert (dx[-3:] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["BayesCpi", "BayesR"])
def test_block_draws_compiled_on_gpu(model, gpu):
    """The compiled Triton kernel at K=64 against the per-SNP scan on the
    card (chip_smoke.py phase 1 runs every method)."""
    spec, consts, pc, sh = make_block(model, 64, seed=64)
    dg_ref, tr_ref = scan_draws(spec, consts, pc, sh)
    dg, tr, _ = kernel_draws(spec, consts, pc, sh)
    g_new = np.asarray(pc["g"]) - np.asarray(dg_ref)
    assert_draws_agree(dg_ref, tr_ref, dg, tr, np.abs(g_new).max() + 1e-12)
