"""int8 HBM-resident genotype: identical chain to the f32 layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hibayes_tpu.engine import gibbs as G


def _mk(geno_dtype, dtype, use_pallas=False):
    rng = np.random.default_rng(6)
    n, m, B = 160, 96, 32
    M = rng.binomial(2, 0.3, size=(n, m)).astype(np.int8)
    y = (M.astype(float) @ rng.normal(0, 0.1, m) + rng.normal(0, 1, n))
    pi = np.array([0.95, 0.05])
    data = G.prepare_gibbs_data(y, M, block=B, dtype=dtype, geno_dtype=geno_dtype)
    pr = G.resolve_priors(y, float(np.asarray(data.vx).sum()), pi[0], nr=0)
    spec = G.GibbsSpec(
        model="BayesCpi", n=n, m=m, m_pad=int(data.xpx.shape[0]), block=B,
        nc=0, nlevels=(), n_fold=2, niter=60, nburn=30, thin=5,
        nvar0=int((np.asarray(data.vx)[:m] == 0).sum()),
        dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare,
        s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0, resync_every=0,
        use_pallas=use_pallas,
    )
    return data, spec, pr, pi


@pytest.mark.parametrize("geno_dtype", ["int8", None])
@pytest.mark.parametrize("m,B", [(96, 32), (100, 32), (40, 64)])
def test_prepared_layout_and_stats_match_numpy(geno_dtype, m, B):
    """Both genotype layouts: the block layout holds M (zero SNP padding
    past m), and the column statistics and level counts match NumPy; a
    monomorphic column has vx exactly 0."""
    rng = np.random.default_rng(m)
    n = 50
    M = rng.binomial(2, 0.3, size=(n, m)).astype(np.int8)
    M[:, 3] = 1
    codes = rng.integers(0, 5, n)
    data = G.prepare_gibbs_data(
        rng.normal(size=n), M, r_codes=(codes,), r_nlevels=(5,), block=B,
        dtype=jnp.float64, geno_dtype=geno_dtype)
    nb, n_rows, blk = data.X_blocks.shape
    m_pad = nb * blk
    assert n_rows == n and m_pad >= m and m_pad % blk == 0
    X = np.asarray(data.X_blocks).transpose(1, 0, 2).reshape(n, m_pad)
    np.testing.assert_array_equal(X[:, :m], M)
    assert np.all(X[:, m:] == 0)
    Mf = M.astype(np.float64)
    vx = np.asarray(data.vx)
    np.testing.assert_allclose(vx[:m], Mf.var(0, ddof=1), rtol=1e-12)
    assert vx[3] == 0.0 and np.all(vx[m:] == 0.0)
    np.testing.assert_allclose(np.asarray(data.xpx)[:m], (Mf * Mf).sum(0))
    np.testing.assert_array_equal(np.asarray(data.r_counts[0]),
                                  np.bincount(codes, minlength=5))


def test_int8_matches_f32_layout():
    data8, spec, pr, pi = _mk("int8", jnp.float64)
    dataf, _, _, _ = _mk(None, jnp.float64)
    assert data8.X_blocks.dtype == jnp.int8
    np.testing.assert_allclose(
        np.asarray(data8.W_blocks), np.asarray(dataf.W_blocks), rtol=1e-12
    )
    np.testing.assert_allclose(np.asarray(data8.vx), np.asarray(dataf.vx), rtol=1e-10)
    _, s8, _ = G.run_chain(spec, data8, pr, pi, seed=3)
    _, sf, _ = G.run_chain(spec, dataf, pr, pi, seed=3)
    np.testing.assert_allclose(
        np.asarray(s8["alpha"]), np.asarray(sf["alpha"]), rtol=1e-8, atol=1e-12
    )


@pytest.mark.slow
def test_int8_pallas_interpret(interpret_kernels):
    data8, spec, pr, pi = _mk("int8", jnp.float32, use_pallas=True)
    _, s, _ = G.run_chain(spec, data8, pr, pi, seed=4)
    assert np.isfinite(np.asarray(s["alpha"])).all()
    assert np.isfinite(np.asarray(s["Vg"])).all()
