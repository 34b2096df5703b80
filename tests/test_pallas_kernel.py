"""Sweep with the Pallas-Triton draws kernel vs the XLA scan path:
identical chains, same randoms.

Runs the kernel in interpret mode on the CPU; chip_smoke.py runs the same
comparison with the kernel compiled for the GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
# heavy interpret-mode compiles: full lane only
pytestmark = [pytest.mark.slow, pytest.mark.usefixtures("interpret_kernels")]


from hibayes_tpu.engine import gibbs as G


def build(model, n=256, m=256, B=128):
    rng = np.random.default_rng(4)
    M = rng.binomial(2, 0.3, size=(n, m)).astype(np.float32)
    y = (M @ rng.normal(0, 0.1, m) + rng.normal(0, 1, n)).astype(np.float32)
    if model == "BayesR":
        nf = 4
        pi = np.array([0.95, 0.02, 0.02, 0.01])
        fold = np.array([0.0, 1e-4, 1e-3, 1e-2])
    else:
        nf = 2
        fold = None
        pi = (
            np.array([0.0, 1.0])
            if model in ("BayesRR", "BayesA", "BayesL")
            else np.array([0.95, 0.05])
        )
    data = G.prepare_gibbs_data(y, M, fold=fold, block=B, dtype=jnp.float32)
    pr = G.resolve_priors(y, float(np.asarray(data.vx).sum()), pi[0], nr=0)
    kw = dict(
        model=model, n=n, m=m, m_pad=int(data.xpx.shape[0]), block=B,
        nc=0, nlevels=(), n_fold=nf, niter=40, nburn=20, thin=5,
        nvar0=int((np.asarray(data.vx)[:m] == 0).sum()),
        dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare,
        s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0, resync_every=0,
        fixpi=model in ("BayesB", "BayesC"),
    )
    spec_x = G.GibbsSpec(use_pallas=False, **kw)
    spec_p = G.GibbsSpec(use_pallas=True, **kw)
    return data, spec_x, spec_p, pr, pi


@pytest.mark.parametrize(
    "model", ["BayesRR", "BayesA", "BayesBpi", "BayesCpi", "BayesL", "BayesR"]
)
def test_pallas_sweep_matches_scan(model):
    """One sweep from the same state with the same randoms.  Both paths are
    f32 with different summation orders, so a discrete mixture draw sitting
    exactly on a uniform threshold can flip; we require <=1% flips and tight
    agreement everywhere the discrete choices agree."""
    data, spec_x, spec_p, pr, pi = build(model)
    key = jax.random.PRNGKey(11)
    s0 = G.init_state(spec_x, data, pr, pi)
    step_x = jax.jit(lambda s: G.one_iteration(spec_x, data, key, s))
    step_p = jax.jit(lambda s: G.one_iteration(spec_p, data, key, s))
    sx = step_x(s0)
    sp = step_p(s0)

    tx, tp = np.asarray(sx.track), np.asarray(sp.track)
    agree = tx == tp
    assert agree.mean() >= 0.99, f"track flips {100 * (1 - agree.mean()):.2f}%"

    gx, gp = np.asarray(sx.g), np.asarray(sp.g)
    scale = np.abs(gx).max() + 1e-12
    np.testing.assert_allclose(gx[agree], gp[agree], rtol=0, atol=5e-5 * scale)

    if agree.all():
        np.testing.assert_allclose(
            np.asarray(sx.yadj), np.asarray(sp.yadj), rtol=0,
            atol=1e-4 * np.abs(np.asarray(sx.yadj)).max() + 1e-6,
        )
        np.testing.assert_allclose(float(sx.vare), float(sp.vare), rtol=1e-3)
    if model == "BayesL":
        vlx, vlp = np.asarray(sx.vargL), np.asarray(sp.vargL)
        close = np.isclose(vlx, vlp, rtol=1e-3)
        assert close.mean() > 0.98  # inv-Gaussian is ulp-sensitive near its mode


def test_pallas_statistical_agreement():
    """Longer chains: posterior means from both paths agree within MC error."""
    data, spec_x, spec_p, pr, pi = build("BayesCpi", n=200, m=128)
    kw = {**spec_x.__dict__}
    kw.update(niter=600, nburn=300)
    spec_x = G.GibbsSpec(**kw)
    kw.update(use_pallas=True)
    spec_p = G.GibbsSpec(**kw)
    _, s1, _ = G.run_chain(spec_x, data, pr, pi, seed=5)
    _, s2, _ = G.run_chain(spec_p, data, pr, pi, seed=5)
    vg1, vg2 = float(np.mean(s1["Vg"])), float(np.mean(s2["Vg"]))
    assert abs(vg1 - vg2) / max(vg1, 1e-9) < 0.25
    a1 = np.mean(s1["alpha"], axis=0)
    a2 = np.mean(s2["alpha"], axis=0)
    assert np.corrcoef(a1, a2)[0, 1] > 0.95
