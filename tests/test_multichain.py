"""Multi-chain execution: vmapped chains match single chains; R-hat sanity."""

import jax
import numpy as np
import pytest

from hibayes_tpu.engine import gibbs as G


def build(n=200, m=96, B=32):
    import jax.numpy as jnp

    rng = np.random.default_rng(8)
    M = rng.binomial(2, 0.3, size=(n, m)).astype(np.float64)
    y = M @ rng.normal(0, 0.15, m) + rng.normal(0, 1, n)
    data = G.prepare_gibbs_data(y, M, block=B, dtype=jnp.float64)
    pi = np.array([0.95, 0.05])
    pr = G.resolve_priors(y, float(np.asarray(data.vx).sum()), pi[0], nr=0)
    spec = G.GibbsSpec(
        model="BayesCpi", n=n, m=m, m_pad=int(data.xpx.shape[0]), block=B,
        nc=0, nlevels=(), n_fold=2, niter=200, nburn=100, thin=5,
        nvar0=int((np.asarray(data.vx)[:m] == 0).sum()),
        dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare,
        s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0, resync_every=0,
    )
    return data, spec, pr, pi


def test_multichain_matches_individual_chains():
    data, spec, pr, pi = build()
    states, samples, extras = G.run_chains(spec, data, pr, pi, seed=5, nchains=3)
    assert samples["alpha"].shape[0] == 3
    # chain 0 of the batch must equal a single chain run with the same key
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    for c in range(3):
        state0 = G.init_state(spec, data, pr, pi)
        _, s_single = G._run_all(spec, data, keys[c], state0)
        np.testing.assert_allclose(
            np.asarray(samples["Vg"][c]), np.asarray(s_single["Vg"]), rtol=1e-10
        )
        np.testing.assert_allclose(
            np.asarray(samples["alpha"][c]),
            np.asarray(s_single["alpha"])[:, : spec.m],
            rtol=1e-10, atol=1e-14,
        )


def test_rhat_converged_chain_near_one():
    data, spec, pr, pi = build()
    _, samples, extras = G.run_chains(spec, data, pr, pi, seed=5, nchains=4)
    rhat = extras["rhat"]
    assert "Vg" in rhat and "Ve" in rhat
    assert 0.9 < rhat["Ve"] < 1.3, rhat
    # vector parameters report the max split-R-hat over subsampled entries
    assert "alpha" in rhat and "pi" in rhat
    assert np.isfinite(rhat["alpha"]) and rhat["alpha"] > 0.8, rhat


def test_vector_rhat_flags_divergent_chains():
    """A parameter column diverging across chains must push max R-hat >> 1."""
    rng = np.random.default_rng(0)
    chains = rng.normal(size=(4, 40, 10))
    chains[2, :, 7] += 50.0  # one chain far away in one entry
    samples = {"alpha": chains}
    rh = G.rhat_diagnostics(samples)
    assert rh["alpha"] > 2.0


@pytest.mark.slow
def test_multichain_pallas_kernel_interpret(interpret_kernels):
    """Multi-chain sweep with the draws kernel vs vmapped XLA sweep
    (interpret mode)."""
    import jax.numpy as jnp

    data, spec, pr, pi = build(n=160, m=128, B=128)
    kw = {**spec.__dict__}
    kw.update(niter=30, nburn=15)
    # rebuild data in f32 for the kernel
    rng = np.random.default_rng(8)
    n, m, B = 160, 128, 128
    M = rng.binomial(2, 0.3, size=(n, m)).astype(np.float32)
    y = (M @ rng.normal(0, 0.15, m) + rng.normal(0, 1, n)).astype(np.float32)
    data32 = G.prepare_gibbs_data(y, M, block=B, dtype=jnp.float32)
    pr32 = G.resolve_priors(y, float(np.asarray(data32.vx).sum()), pi[0], nr=0)
    kw2 = dict(kw)
    kw2.update(m_pad=int(data32.xpx.shape[0]), block=B,
               nvar0=int((np.asarray(data32.vx)[:m] == 0).sum()))
    spec_x = G.GibbsSpec(**kw2)
    spec_p = G.GibbsSpec(**{**kw2, "use_pallas": True})

    keys = jax.random.split(jax.random.PRNGKey(4), 4)
    s0 = G.init_state(spec_x, data32, pr32, pi)
    states0 = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (4,) + x.shape), s0)
    sx = G.one_iteration_batch(spec_x, data32, keys, states0)
    sp = G.one_iteration_batch(spec_p, data32, keys, states0)
    gx, gp = np.asarray(sx.g), np.asarray(sp.g)
    agree = np.asarray(sx.track) == np.asarray(sp.track)
    assert agree.mean() >= 0.99
    scale = np.abs(gx).max() + 1e-12
    np.testing.assert_allclose(gx[agree], gp[agree], rtol=0, atol=5e-5 * scale)


@pytest.mark.slow
def test_multichain_snp_mesh_matches_unsharded():
    """nchains>1 on a (snp>1) mesh runs the turn-based shard schedule with
    all chains per turn (_sweep_snp_sharded_mc) and must reproduce the
    unsharded multi-chain run bit-for-bit in f64 (the psum merge adds exact
    zeros from inactive shards; VERDICT r3 item 3)."""
    from hibayes_tpu.parallel.mesh import make_mesh

    data, spec, pr, pi = build(n=64, m=128, B=32)  # 4 blocks: divisible by snp=4
    kw = {**spec.__dict__}
    kw.update(niter=40, nburn=20)
    spec = G.GibbsSpec(**kw)
    _, sam1, _ = G.run_chains(spec, data, pr, pi, seed=5, nchains=2)
    mesh = make_mesh(4, shape=(1, 4))
    _, sam4, _ = G.run_chains(spec, data, pr, pi, seed=5, nchains=2, mesh=mesh)
    np.testing.assert_allclose(np.asarray(sam1["Vg"]), np.asarray(sam4["Vg"]),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(sam1["alpha"]),
                               np.asarray(sam4["alpha"]), rtol=1e-9, atol=1e-13)
