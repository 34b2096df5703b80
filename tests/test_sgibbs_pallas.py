"""Summary engine with the Pallas draws kernel vs the XLA scan path
(interpret mode on CPU)."""

import jax
import numpy as np
import pytest
# heavy interpret-mode compiles: full lane only
pytestmark = [pytest.mark.slow, pytest.mark.usefixtures("interpret_kernels")]


from hibayes_tpu.engine import gibbs as G
from hibayes_tpu.engine import sgibbs as SG
from tests.test_sgibbs_exact import make_problem


@pytest.mark.parametrize("model,blockdiag", [
    ("BayesCpi", False), ("BayesCpi", True), ("BayesRR", False), ("BayesR", False),
])
def test_sgibbs_pallas_matches_scan(model, blockdiag):
    import jax.numpy as jnp

    # rebuild the problem in f32 (kernel requirement)
    data, spec, pr, pi = make_problem(model, blockdiag=blockdiag)
    data32 = SG.SGibbsData(
        ld_segs=tuple(s.astype(jnp.float32) for s in data.ld_segs),
        xy=data.xy.astype(jnp.float32),
        xpx=data.xpx.astype(jnp.float32),
        vx=data.vx.astype(jnp.float32),
        real=data.real,
        varediff=data.varediff.astype(jnp.float32),
        fold=data.fold.astype(jnp.float32),
        windindx0=data.windindx0,
        yy=data.yy.astype(jnp.float32),
    )
    spec_x = spec
    spec_p = G.GibbsSpec(**{**spec.__dict__, "use_pallas": True})
    key = jax.random.PRNGKey(33)
    s0 = SG.init_s_state(spec_x, data32, pr, pi)
    sx = jax.jit(lambda s: SG.one_s_iteration(spec_x, data32, key, s))(s0)
    sp = jax.jit(lambda s: SG.one_s_iteration(spec_p, data32, key, s))(s0)

    tx, tp = np.asarray(sx.track), np.asarray(sp.track)
    agree = tx == tp
    assert agree.mean() >= 0.99, f"track flips {100 * (1 - agree.mean()):.2f}%"
    gx, gp = np.asarray(sx.g), np.asarray(sp.g)
    scale = np.abs(gx).max() + 1e-12
    np.testing.assert_allclose(gx[agree], gp[agree], rtol=0, atol=5e-5 * scale)
    if agree.all():
        np.testing.assert_allclose(
            np.asarray(sx.r_hat), np.asarray(sp.r_hat), rtol=0,
            atol=2e-4 * np.abs(np.asarray(sx.r_hat)).max() + 1e-6,
        )


def _f32_data(data):
    import jax.numpy as jnp

    return SG.SGibbsData(
        ld_segs=tuple(s.astype(jnp.float32) for s in data.ld_segs),
        xy=data.xy.astype(jnp.float32),
        xpx=data.xpx.astype(jnp.float32),
        vx=data.vx.astype(jnp.float32),
        real=data.real,
        varediff=data.varediff.astype(jnp.float32),
        fold=data.fold.astype(jnp.float32),
        windindx0=data.windindx0,
        yy=data.yy.astype(jnp.float32),
    )


@pytest.mark.parametrize("model", ["BayesCpi", "BayesR"])
def test_s_multichain_kernel_matches_vmapped_scan(model):
    """one_s_iteration_batch (segment sweep with the draws kernel) vs
    the vmapped XLA scan for K chains in one iteration."""
    import jax.numpy as jnp

    data, spec, pr, pi = make_problem(model)
    data32 = _f32_data(data)
    spec_x = G.GibbsSpec(**{**spec.__dict__})
    spec_p = G.GibbsSpec(**{**spec.__dict__, "use_pallas": True})
    K = 3
    s0 = SG.init_s_state(spec_x, data32, pr, pi)
    states = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (K,) + x.shape), s0
    )
    keys = jax.random.split(jax.random.PRNGKey(7), K)
    assert G._kernel_draws(spec_p, jnp.float32)
    sx = jax.jit(lambda ss: SG.one_s_iteration_batch(spec_x, data32, keys, ss))(states)
    sp = jax.jit(lambda ss: SG.one_s_iteration_batch(spec_p, data32, keys, ss))(states)
    tx, tp = np.asarray(sx.track), np.asarray(sp.track)
    agree = tx == tp
    assert agree.mean() >= 0.99
    gx, gp = np.asarray(sx.g), np.asarray(sp.g)
    scale = np.abs(gx).max() + 1e-12
    np.testing.assert_allclose(gx[agree], gp[agree], rtol=0, atol=5e-5 * scale)


def test_run_s_chains_matches_single_chains():
    """Multi-chain summary runner (XLA fallback path) reproduces each chain
    run individually with the same key; R-hat present."""
    data, spec, pr, pi = make_problem("BayesCpi")
    kw = {**spec.__dict__}
    kw.update(niter=60, nburn=30)
    spec2 = G.GibbsSpec(**kw)
    states, samples, extras = SG.run_s_chains(spec2, data, pr, pi, seed=9, nchains=3)
    assert "rhat" in extras and "Vg" in extras["rhat"]
    keys = jax.random.split(jax.random.PRNGKey(9), 3)
    for c in range(3):
        s0 = SG.init_s_state(spec2, data, pr, pi)
        _, s_single = SG._run_all_s(spec2, data, keys[c], s0)
        np.testing.assert_allclose(
            np.asarray(samples["Vg"][c]), np.asarray(s_single["Vg"]), rtol=1e-10
        )
