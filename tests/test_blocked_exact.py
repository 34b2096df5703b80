"""Exactness of the blocked Gibbs vs. the sequential NumPy oracle.

The blocked formulation must reproduce the reference's sequential
per-SNP chain (same randoms -> same chain) to fp tolerance.  This is the
structural proof that blocking does not change the Markov kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hibayes_tpu.engine import gibbs as G
from .oracle import oracle_iteration

BLOCK = 32


def make_problem(model, seed=3, n=120, m=96, nc=0, nr=0, mono=True):
    rng = np.random.default_rng(seed)
    M = rng.binomial(2, rng.uniform(0.05, 0.5, size=m), size=(n, m)).astype(np.float64)
    if mono:
        M[:, 7] = 1.0  # a monomorphic SNP: vx == 0, must be skipped
    y = (M @ rng.normal(0, 0.1, m) + rng.normal(0, 1, n)).astype(np.float64)
    C = rng.normal(size=(n, nc)).astype(np.float64) if nc else None
    r_codes, r_nlev = (), ()
    if nr:
        r_codes = tuple(rng.integers(0, 5, n).astype(np.int32) for _ in range(nr))
        r_nlev = tuple(5 for _ in range(nr))

    n_fold = 4 if model == "BayesR" else 2
    pi = np.array([0.95, 0.02, 0.02, 0.01]) if model == "BayesR" else np.array([0.95, 0.05])
    fold = np.array([0.0, 1e-4, 1e-3, 1e-2]) if model == "BayesR" else None
    if model in ("BayesRR", "BayesA", "BayesL"):
        pi = np.array([0.0, 1.0])

    data = G.prepare_gibbs_data(
        y, M, C=C, r_codes=r_codes, r_nlevels=r_nlev, fold=fold, block=BLOCK,
        dtype=jnp.float64,
    )
    vx = np.asarray(data.vx)
    nvar0 = int((vx[:m] == 0).sum())
    pr = G.resolve_priors(y, float(vx.sum()), pi[0], nr=nr)
    spec = G.GibbsSpec(
        model=model, n=n, m=m, m_pad=int(data.xpx.shape[0]), block=BLOCK,
        nc=nc, nlevels=r_nlev, n_fold=n_fold, niter=40, nburn=20, thin=5,
        nvar0=nvar0, fixpi=model in ("BayesB", "BayesC"),
        dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare,
        dfr=pr.dfr, s2r=pr.s2r, s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0,
        resync_every=0,
    )
    return data, spec, pr, pi, M, y, C, r_codes


@pytest.mark.parametrize(
    "model", ["BayesRR", "BayesA", "BayesB", "BayesBpi", "BayesC", "BayesCpi", "BayesL", "BayesR"]
)
def test_blocked_matches_sequential_oracle(model):
    nc, nr = (2, 1) if model in ("BayesCpi", "BayesR") else (0, 0)
    data, spec, pr, pi, M, y, C, r_codes = make_problem(model, nc=nc, nr=nr)
    base_key = jax.random.PRNGKey(7)

    state = G.init_state(spec, data, pr, pi)
    step = jax.jit(lambda s: G.one_iteration(spec, data, base_key, s))

    m_pad = spec.m_pad
    Xp = np.zeros((spec.n, m_pad))
    Xp[:, : spec.m] = M
    dnp = {
        "X": Xp,
        "xpx": np.asarray(data.xpx, dtype=np.float64),
        "vx": np.asarray(data.vx, dtype=np.float64),
        "C": np.asarray(C) if C is not None else np.zeros((spec.n, 0)),
        "r_codes": [np.asarray(c) for c in r_codes],
        "fold": np.asarray(data.fold, dtype=np.float64),
    }
    ost = {
        "it": 0,
        "mu": float(np.mean(y)),
        "beta": np.zeros(nc),
        "estR": [np.zeros(nl) for nl in spec.nlevels],
        "vrtmp": np.full(nr, pr.vr_init),
        "vr": np.zeros(nr),
        "yadj": y - np.mean(y),
        "u": np.zeros(spec.n),
        "g": np.zeros(m_pad),
        "varg": pr.varg,
        "vargL": np.full(m_pad, pr.varg),
        "lambda2": pr.lambda2,
        "pi": pi.astype(np.float64),
        "vara_fold": pr.varg * np.asarray(data.fold, dtype=np.float64),
        "vara": pr.vara,
        "vare": pr.vare,
    }

    for it in range(3):
        state = step(state)
        ost = oracle_iteration(spec, dnp, base_key, ost)

        np.testing.assert_allclose(np.asarray(state.g), ost["g"], rtol=1e-8, atol=1e-10,
                                   err_msg=f"g mismatch at iter {it}")
        np.testing.assert_allclose(np.asarray(state.yadj), ost["yadj"], rtol=1e-8, atol=1e-9)
        np.testing.assert_allclose(float(state.mu), ost["mu"], rtol=1e-10)
        np.testing.assert_allclose(float(state.vare), ost["vare"], rtol=1e-8)
        np.testing.assert_allclose(float(state.vara), ost["vara"], rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(np.asarray(state.pi), ost["pi"], rtol=1e-8)
        if model == "BayesL":
            np.testing.assert_allclose(
                np.asarray(state.vargL), ost["vargL"], rtol=1e-8
            )
            np.testing.assert_allclose(float(state.lambda2), ost["lambda2"], rtol=1e-8)
        if nc:
            np.testing.assert_allclose(np.asarray(state.beta), ost["beta"], rtol=1e-8)
        if nr:
            np.testing.assert_allclose(np.asarray(state.estR[0]), ost["estR"][0], rtol=1e-8)
        if model in ("BayesB", "BayesBpi", "BayesC", "BayesCpi", "BayesR"):
            np.testing.assert_array_equal(np.asarray(state.track), ost["track"],
                                          err_msg=f"mixture assignment mismatch at iter {it}")
