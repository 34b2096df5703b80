"""Tiled-sparse summary sweep: draws kernel (interpret mode) vs XLA scan.

Both touch only stored tiles — the same Markov kernel; the only permitted
divergence is the bounded in-kernel rejection guard (N_RETRY precomputed
draws vs the scan's while-loop, reference src/SBayesS.cpp:388-398) which
must not fire on well-conditioned data.
"""

import jax
import numpy as np
import pytest
# heavy interpret-mode compiles: full lane only
pytestmark = [pytest.mark.slow, pytest.mark.usefixtures("interpret_kernels")]


from hibayes_tpu.data.sparse_ld import build_tiled_ld
from hibayes_tpu.engine import gibbs as G
from hibayes_tpu.engine import sgibbs as SG
from tests.test_tiled_ld import _banded_geno, _sumstat


def _make_tiled_problem(model, m=512, tile=128):
    import jax.numpy as jnp

    X = _banded_geno(n=400, m=m, seed=5)
    ss = _sumstat(X, seed=2)
    ld = build_tiled_ld(X, chisq=30.0, tile=tile, stripe=2 * tile)
    if m // tile >= 4:
        assert not ld.valid.all(), "pattern should have masked tiles for the test"
    fold = np.array([0.0, 1e-4, 1e-3, 1e-2]) if model == "BayesR" else np.array([0.0, 1.0])
    pi = (np.array([0.95, 0.02, 0.02, 0.01]) if model == "BayesR"
          else np.array([0.95, 0.05]))
    data, n_eff, vary, nvar0, seg_sizes, seg_real = SG.prepare_sgibbs_data(
        ss, ld, fold=fold, block=tile, dtype=jnp.float32)
    pr = G.resolve_priors(None, float(np.sum(np.asarray(ld.diag))), float(pi[0]),
                          nr=0, vary=vary)
    spec = G.GibbsSpec(
        model=model, n=n_eff, m=m, m_pad=int(sum(seg_sizes)), block=tile,
        nc=0, nlevels=(), n_fold=len(pi), niter=40, nburn=20, thin=5,
        nvar0=nvar0, dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare,
        s2vare=pr.s2vare, s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0,
        vargl_strict_pos=True, reject_guard=True, vary=vary,
        seg_sizes=seg_sizes, seg_real=seg_real, use_pallas=False,
    )
    return data, spec, pr, pi


@pytest.mark.parametrize("model", ["BayesCpi", "BayesRR", "BayesR"])
def test_tiled_pallas_matches_scan(model):
    data, spec, pr, pi = _make_tiled_problem(model)
    spec_p = G.GibbsSpec(**{**spec.__dict__, "use_pallas": True})
    assert G._kernel_draws(spec_p, data.xy.dtype)

    key = jax.random.PRNGKey(33)
    s0 = SG.init_s_state(spec, data, pr, pi)
    sx = jax.jit(lambda s: SG.one_s_iteration(spec, data, key, s))(s0)
    sp = jax.jit(lambda s: SG.one_s_iteration(spec_p, data, key, s))(s0)

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
    # chain-level stats after a few iterations stay in agreement
    step_x = jax.jit(lambda s: SG.one_s_iteration(spec, data, key, s))
    step_p = jax.jit(lambda s: SG.one_s_iteration(spec_p, data, key, s))
    for _ in range(3):
        sx, sp = step_x(sx), step_p(sp)
    np.testing.assert_allclose(float(sx.vara), float(sp.vara), rtol=2e-2)
    np.testing.assert_allclose(float(sx.vare), float(sp.vare), rtol=2e-2)


def test_retry_rows_shapes():
    """Guard rows: [vx] + NR (BayesC) or NR*(nf-1) (BayesR) sd*z rows."""
    import jax.numpy as jnp

    from hibayes_tpu.ops import blockgibbs

    data, spec, pr, pi = _make_tiled_problem("BayesR", m=256)
    m_pad = spec.m_pad
    z = jax.random.normal(jax.random.PRNGKey(0), (blockgibbs.N_RETRY, m_pad),
                          dtype=jnp.float32)
    consts = {
        "varg": jnp.asarray(pr.varg, jnp.float32),
        "vara_fold": jnp.asarray(pr.varg * data.fold, jnp.float32),
    }
    rows = blockgibbs._pack_retry_rows(spec, consts, data.xpx, data.vx,
                                       data.varediff * pr.vara + pr.vare, z)
    assert rows.shape == (1 + blockgibbs.N_RETRY * (spec.n_fold - 1), m_pad)
    spec_c = G.GibbsSpec(**{**spec.__dict__, "model": "BayesCpi", "n_fold": 2})
    rows_c = blockgibbs._pack_retry_rows(spec_c, consts, data.xpx, data.vx,
                                         data.varediff * pr.vara + pr.vare, z)
    assert rows_c.shape == (1 + blockgibbs.N_RETRY, m_pad)
    assert bool(jnp.isfinite(rows).all()) and bool(jnp.isfinite(rows_c).all())
