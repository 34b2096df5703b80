"""Multi-device sharding: the n-sharded chain must match single-device exactly.

Runs on the virtual 8-device CPU mesh from conftest (the same mechanism the
multi-device logic is validated with, SURVEY.md section 4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
pytestmark = pytest.mark.slow  # heavy shard_map/interpret compiles: full lane only


from hibayes_tpu.engine import gibbs as G
from hibayes_tpu.parallel.mesh import make_mesh, shard_gibbs_data, shard_state


def build(model="BayesCpi", n=160, m=96, block=32, dtype=jnp.float64, nc=2, nr=1):
    rng = np.random.default_rng(9)
    M = rng.binomial(2, 0.3, size=(n, m)).astype(np.float64)
    y = (M @ rng.normal(0, 0.1, m) + rng.normal(0, 1, n))
    C = rng.normal(size=(n, nc))
    codes = (rng.integers(0, 4, n).astype(np.int32),)
    data = G.prepare_gibbs_data(
        y, M, C=C, r_codes=codes, r_nlevels=(4,), block=block, dtype=dtype
    )
    pi = np.array([0.95, 0.05])
    pr = G.resolve_priors(y, float(np.asarray(data.vx).sum()), pi[0], nr=nr)
    spec = G.GibbsSpec(
        model=model, n=n, m=m, m_pad=int(data.xpx.shape[0]), block=block,
        nc=nc, nlevels=(4,), n_fold=2, niter=60, nburn=30, thin=5,
        nvar0=int((np.asarray(data.vx)[:m] == 0).sum()),
        dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare,
        dfr=pr.dfr, s2r=pr.s2r, s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0,
        resync_every=0,
    )
    return data, spec, pr, pi


def test_eight_device_mesh_available():
    assert len(jax.devices()) == 8


def test_sharded_chain_matches_single_device():
    data, spec, pr, pi = build()
    _, samples1, ex1 = G.run_chain(spec, data, pr, pi, seed=17)

    mesh = make_mesh(8, shape=(8, 1))
    _, samples8, ex8 = G.run_chain(spec, data, pr, pi, seed=17, mesh=mesh)

    np.testing.assert_allclose(
        np.asarray(samples1["alpha"]), np.asarray(samples8["alpha"]),
        rtol=1e-8, atol=1e-10,
    )
    np.testing.assert_allclose(
        np.asarray(samples1["Vg"]), np.asarray(samples8["Vg"]), rtol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(ex1["pip"]), np.asarray(ex8["pip"]), rtol=1e-8
    )


def test_snp_sharded_chain_matches_single_device():
    """SNP-axis model parallelism (SURVEY §2.3 P3): X/W block shards live on
    their own devices, shards sweep in turn with psum-merged residual
    corrections — the chain must match single-device to the same standard as
    the ind-sharded test."""
    data, spec, pr, pi = build(m=512)  # 16 blocks: divisible by 8 shards
    _, s1, ex1 = G.run_chain(spec, data, pr, pi, seed=17)
    mesh = make_mesh(8, shape=(1, 8))
    _, s8, ex8 = G.run_chain(spec, data, pr, pi, seed=17, mesh=mesh)
    np.testing.assert_allclose(
        np.asarray(s1["alpha"]), np.asarray(s8["alpha"]), rtol=1e-8, atol=1e-10
    )
    np.testing.assert_allclose(np.asarray(s1["Vg"]), np.asarray(s8["Vg"]), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(ex1["pip"]), np.asarray(ex8["pip"]), rtol=1e-8)


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_2d_mesh_matches_single_device(shape):
    """Simultaneous n-DP + m-MP: equality, not just finiteness."""
    data, spec, pr, pi = build(m=512)
    _, s1, ex1 = G.run_chain(spec, data, pr, pi, seed=17)
    mesh = make_mesh(8, shape=shape)
    _, s8, ex8 = G.run_chain(spec, data, pr, pi, seed=17, mesh=mesh)
    np.testing.assert_allclose(
        np.asarray(s1["alpha"]), np.asarray(s8["alpha"]), rtol=1e-8, atol=1e-10
    )
    np.testing.assert_allclose(np.asarray(ex1["pip"]), np.asarray(ex8["pip"]), rtol=1e-8)


def test_snp_sharding_scales_memory():
    """The compiled step must NOT gather the full genotype to one device:
    per-device live temp stays far below the global X size (the property that
    lets 50k x 500k int8 = 25 GB span several devices)."""
    from functools import partial

    from hibayes_tpu.parallel.mesh import shard_gibbs_data, shard_state

    data, spec, pr, pi = build(m=2048, n=256, block=32)  # X = 4.2 MB global
    mesh = make_mesh(8, shape=(1, 8))
    d8 = shard_gibbs_data(data, mesh)
    st0 = shard_state(G.init_state(spec, d8, pr, pi), mesh)
    with mesh:
        compiled = (
            jax.jit(partial(G.one_iteration, spec, mesh=mesh))
            .lower(d8, jax.random.PRNGKey(0), st0)
            .compile()
        )
    xbytes = data.X_blocks.size * data.X_blocks.dtype.itemsize
    temp = compiled.memory_analysis().temp_size_in_bytes
    assert temp < xbytes / 4, f"temp {temp} vs X {xbytes}: full gather suspected"


def test_snp_sharded_with_bslmm_unsupported_falls_back():
    """Non-divisible block counts keep the replicated layout and still match."""
    data, spec, pr, pi = build(m=96)  # 3 blocks: NOT divisible by 8
    _, s1, _ = G.run_chain(spec, data, pr, pi, seed=5)
    mesh = make_mesh(8, shape=(1, 8))
    _, s8, _ = G.run_chain(spec, data, pr, pi, seed=5, mesh=mesh)
    np.testing.assert_allclose(
        np.asarray(s1["alpha"]), np.asarray(s8["alpha"]), rtol=1e-8, atol=1e-10
    )


def test_sharded_matches_for_bayesr():
    data, spec, pr, pi = build()
    rng = np.random.default_rng(1)
    pi = np.array([0.95, 0.02, 0.02, 0.01])
    fold = np.array([0.0, 1e-4, 1e-3, 1e-2])
    data = data._replace(fold=jnp.asarray(fold, jnp.float64))
    spec = G.GibbsSpec(**{**spec.__dict__, "model": "BayesR", "n_fold": 4})
    _, s1, _ = G.run_chain(spec, data, pr, pi, seed=3)
    mesh = make_mesh(8, shape=(8, 1))
    _, s8, _ = G.run_chain(spec, data, pr, pi, seed=3, mesh=mesh)
    np.testing.assert_allclose(
        np.asarray(s1["alpha"]), np.asarray(s8["alpha"]), rtol=1e-8, atol=1e-10
    )


def test_ibrm_api_mesh_equality():
    """mesh= exposed through the high-level API: sharded fit == unsharded."""
    import jax.numpy as jnp

    import hibayes_tpu as ht

    rng = np.random.default_rng(0)
    n, m = 160, 512
    M = rng.binomial(2, 0.3, (n, m)).astype(np.float64)
    y = M @ rng.normal(0, 0.1, m) + rng.normal(0, 1, n)
    data = {"id": np.array([f"I{i}" for i in range(n)]), "y": y}
    kw = dict(data=data, M=M, M_id=data["id"], method="BayesCpi", niter=200,
              nburn=100, verbose=False, dtype=jnp.float64, block=32)
    f1 = ht.ibrm("y~1", **kw)
    f8 = ht.ibrm("y~1", mesh=make_mesh(8, shape=(2, 4)), **kw)
    np.testing.assert_allclose(f8.Vg, f1.Vg, rtol=1e-8)
    np.testing.assert_allclose(f8.alpha, f1.alpha, atol=1e-10)


def test_ibrm_api_pipeline_schedule():
    """shard_schedule='pipeline' through the high-level API: 4 chains
    ring-rotating over a 4-shard m-MP mesh produce a sane multi-chain fit."""
    import hibayes_tpu as ht

    rng = np.random.default_rng(1)
    n, m = 160, 512
    M = rng.binomial(2, 0.3, (n, m)).astype(np.float64)
    y = M @ rng.normal(0, 0.1, m) + rng.normal(0, 1, n)
    data = {"id": np.array([f"I{i}" for i in range(n)]), "y": y}
    kw = dict(data=data, M=M, M_id=data["id"], method="BayesCpi", niter=120,
              nburn=60, verbose=False, block=32)
    f1 = ht.ibrm("y~1", nchains=4, **kw)
    fp = ht.ibrm("y~1", nchains=4, mesh=make_mesh(4, shape=(1, 4)),
                 shard_schedule="pipeline", **kw)
    assert np.isfinite(fp.alpha).all()
    assert abs(fp.Vg - f1.Vg) / max(f1.Vg, 1e-9) < 0.5
    assert np.corrcoef(fp.alpha, f1.alpha)[0, 1] > 0.8


def test_shard_state_is_sharding_fixed_point():
    """shard_state must place the chain state exactly as one_iteration emits
    it, so threaded state (segmented checkpoint runner, benchmark loops)
    reuses one jit cache entry.  A mismatch costs a full second compile —
    observed as seconds/call hidden inside a timed loop."""
    from functools import partial

    data, spec, pr, pi = build()
    # cover the snp-sharded and 2-D shapes the flagship m-MP path uses, not
    # just ind-only meshes — an output-sharding mismatch there would
    # silently reintroduce the hidden-recompile-per-iteration bug
    for shape in ((1, 1), (8, 1), (1, 8), (2, 4)):
        mesh = make_mesh(shape[0] * shape[1], shape=shape)
        d = shard_gibbs_data(data, mesh)
        st = shard_state(G.init_state(spec, d, pr, pi), mesh)
        with mesh:
            step = jax.jit(partial(G.one_iteration, spec, mesh=mesh))
            out = jax.block_until_ready(step(d, jax.random.PRNGKey(0), st))
        for name in ("yadj", "u", "g"):
            s_in = getattr(st, name).sharding
            s_out = getattr(out, name).sharding
            assert s_out.is_equivalent_to(s_in, getattr(st, name).ndim), (
                f"mesh {shape}: {name} in={s_in} out={s_out}"
            )
