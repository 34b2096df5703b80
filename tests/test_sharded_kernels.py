"""The Pallas draws kernel under sharded meshes.

Three production paths are exercised in interpret mode on the 8-device CPU
mesh (chip_smoke.py --four-cards runs them compiled on four GPUs):

* SNP-sharded turn loop running the draws kernel shard-locally
  (pure m-MP: `engine/gibbs._sweep_snp_sharded`).
* ind-sharded hybrid: shard_map-wrapped per-block draws kernel with psum'd
  r0 — the path that makes `use_pallas` SAFE under an ind mesh (pallas_call
  has no GSPMD rule; routing it unguarded would gather the full genotype).
* SNP-sharded tiled summary sweep running the draws kernel shard-locally
  with a row offset (`engine/sgibbs._tiled_sweep_snp_sharded`).

Both paths draw from identical RNG streams as the unsharded kernel, so one
iteration from the same state agrees up to f32 merge wobble: we assert the
same standard as tests/test_pallas_kernel.py (<=1% discrete flips, tight
agreement where the discrete choices agree).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
# heavy shard_map/interpret compiles: full lane only
pytestmark = [pytest.mark.slow, pytest.mark.usefixtures("interpret_kernels")]


import hibayes_tpu as ht
from hibayes_tpu.engine import gibbs as G
from hibayes_tpu.engine import sgibbs as SG
from hibayes_tpu.parallel.mesh import make_mesh, shard_gibbs_data, shard_state


def build(model="BayesCpi", n=256, m=1024, B=128, nc=0, nr=0, seed=4):
    rng = np.random.default_rng(seed)
    M = rng.binomial(2, 0.3, size=(n, m)).astype(np.float32)
    y = (M @ rng.normal(0, 0.1, m) + rng.normal(0, 1, n)).astype(np.float32)
    if model == "BayesR":
        nf, pi = 4, np.array([0.95, 0.02, 0.02, 0.01])
        fold = np.array([0.0, 1e-4, 1e-3, 1e-2])
    else:
        nf, pi, fold = 2, np.array([0.95, 0.05]), None
    C = rng.normal(size=(n, nc)).astype(np.float32) if nc else None
    codes = (rng.integers(0, 4, n).astype(np.int32),) if nr else ()
    data = G.prepare_gibbs_data(
        y, M, C=C, r_codes=codes, r_nlevels=(4,) * nr, fold=fold, block=B,
        dtype=jnp.float32,
    )
    pr = G.resolve_priors(y, float(np.asarray(data.vx).sum()), pi[0], nr=nr)
    kw = dict(
        model=model, n=n, m=m, m_pad=int(data.xpx.shape[0]), block=B,
        nc=nc, nlevels=(4,) * nr, n_fold=nf, niter=40, nburn=20, thin=5,
        nvar0=int((np.asarray(data.vx)[:m] == 0).sum()),
        dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare,
        dfr=pr.dfr, s2r=pr.s2r, s2varg=pr.s2varg,
        lambda_rate0=pr.lambda_rate0, resync_every=0,
    )
    spec = G.GibbsSpec(use_pallas=True, **kw)
    return data, spec, pr, pi


def one_iter(spec, data, state, mesh=None):
    if mesh is None:
        step = jax.jit(partial(G.one_iteration, spec))
        return step(data, jax.random.PRNGKey(11), state)
    d = shard_gibbs_data(data, mesh)
    st = shard_state(state, mesh)
    with mesh:
        step = jax.jit(partial(G.one_iteration, spec, mesh=mesh))
        return jax.block_until_ready(step(d, jax.random.PRNGKey(11), st))


def assert_sweep_agrees(s_ref, s_test, min_agree=0.99):
    tx, tp = np.asarray(s_ref.track), np.asarray(s_test.track)
    agree = tx == tp
    assert agree.mean() >= min_agree, f"track flips {100*(1-agree.mean()):.2f}%"
    gx, gp = np.asarray(s_ref.g), np.asarray(s_test.g)
    scale = np.abs(gx).max() + 1e-12
    np.testing.assert_allclose(gx[agree], gp[agree], rtol=0, atol=5e-5 * scale)
    if agree.all() and hasattr(s_ref, "yadj"):
        np.testing.assert_allclose(
            np.asarray(s_ref.yadj), np.asarray(s_test.yadj), rtol=0,
            atol=1e-4 * np.abs(np.asarray(s_ref.yadj)).max() + 1e-6,
        )


@pytest.mark.parametrize("model", ["BayesCpi", "BayesR"])
def test_snp_sharded_kernel_matches_unsharded_kernel(model):
    """Pure m-MP mesh: the turn loop must run the draws kernel
    shard-locally and reproduce the unsharded kernel sweep."""
    data, spec, pr, pi = build(model)
    # the selection must actually pick the kernel for this config
    assert G._kernel_draws(spec, jnp.float32)
    s0 = G.init_state(spec, data, pr, pi)
    s1 = one_iter(spec, data, s0)
    s8 = one_iter(spec, data, s0, mesh=make_mesh(8, shape=(1, 8)))
    assert_sweep_agrees(s1, s8)


def test_2d_mesh_hybrid_matches_unsharded_kernel():
    """m-MP x n-DP mesh: the turn loop's shard-local sweep is the per-block
    hybrid (psum'd r0 + (B,1) draw kernel) — same streams, same chain."""
    data, spec, pr, pi = build("BayesCpi")
    s0 = G.init_state(spec, data, pr, pi)
    s1 = one_iter(spec, data, s0)
    s8 = one_iter(spec, data, s0, mesh=make_mesh(8, shape=(2, 4)))
    assert_sweep_agrees(s1, s8)


@pytest.mark.parametrize("model", ["BayesCpi", "BayesR"])
def test_ind_sharded_hybrid_matches_unsharded_kernel(model):
    """ind-only mesh with use_pallas=True must route the shard_map hybrid
    (shard_map around the kernel, never a gather of X) and agree."""
    data, spec, pr, pi = build(model, m=512)
    assert G._kernel_draws(spec, jnp.float32)
    s0 = G.init_state(spec, data, pr, pi)
    s1 = one_iter(spec, data, s0)
    s8 = one_iter(spec, data, s0, mesh=make_mesh(8, shape=(8, 1)))
    assert_sweep_agrees(s1, s8)


def test_ind_sharded_pallas_no_full_gather():
    """Compile-memory mirror of test_snp_sharding_scales_memory for the IND
    axis with use_pallas=True: per-device temp must stay far below the global
    X (the hybrid keeps X sharded; only (B,K) tiles reach pallas)."""
    data, spec, pr, pi = build("BayesCpi", n=2048, m=512, B=128)
    mesh = make_mesh(8, shape=(8, 1))
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
    assert temp < xbytes / 2, f"temp {temp} vs X {xbytes}: full gather suspected"


def _batched(spec, data, pr, pi, K):
    s0 = G.init_state(spec, data, pr, pi)
    states = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (K,) + x.shape), s0)
    keys = jax.random.split(jax.random.PRNGKey(5), K)
    return states, keys


def batch_one_iter(spec, data, states, keys, mesh=None):
    if mesh is None:
        step = jax.jit(partial(G.one_iteration_batch, spec))
        return step(data, keys, states)
    d = shard_gibbs_data(data, mesh)
    with mesh:
        step = jax.jit(partial(G.one_iteration_batch, spec, mesh=mesh))
        return jax.block_until_ready(step(d, keys, states))


@pytest.mark.parametrize("model", ["BayesCpi", "BayesR"])
def test_multichain_snp_sharded_matches_unsharded_kernel(model):
    """m-MP x multi-chain: the turn loop runs the draws kernel
    shard-locally for all K chains and must reproduce the unsharded
    multi-chain kernel sweep."""
    data, spec, pr, pi = build(model)
    K = 3
    assert G._kernel_draws(spec, jnp.float32)
    states, keys = _batched(spec, data, pr, pi, K)
    s1 = batch_one_iter(spec, data, states, keys)
    s8 = batch_one_iter(spec, data, states, keys, mesh=make_mesh(8, shape=(1, 8)))
    assert_sweep_agrees(s1, s8)


def test_multichain_2d_mesh_hybrid_matches_unsharded_kernel():
    """m-MP x n-DP x multi-chain: the turn loop's shard-local sweep is the
    per-block hybrid with K chains on the lanes — same streams, same chain."""
    data, spec, pr, pi = build("BayesCpi")
    states, keys = _batched(spec, data, pr, pi, 3)
    s1 = batch_one_iter(spec, data, states, keys)
    s8 = batch_one_iter(spec, data, states, keys, mesh=make_mesh(8, shape=(2, 4)))
    assert_sweep_agrees(s1, s8)


def test_multichain_snp_sharded_no_full_gather():
    """Compile-memory assertion for the m-MP x multi-chain path: per-device
    temp must stay far below the global X (each shard's kernels see only its
    own X blocks; no re-gather per iteration)."""
    data, spec, pr, pi = build("BayesCpi", n=512, m=4096, B=128)
    mesh = make_mesh(8, shape=(1, 8))
    d8 = shard_gibbs_data(data, mesh)
    states, keys = _batched(spec, d8, pr, pi, 4)
    with mesh:
        compiled = (
            jax.jit(partial(G.one_iteration_batch, spec, mesh=mesh))
            .lower(d8, keys, states)
            .compile()
        )
    xbytes = data.X_blocks.size * data.X_blocks.dtype.itemsize
    temp = compiled.memory_analysis().temp_size_in_bytes
    assert temp < xbytes / 2, f"temp {temp} vs X {xbytes}: full gather suspected"


def test_multichain_ind_sharded_hybrid():
    """nchains>1 on an ind mesh with use_pallas=True: the batched hybrid runs
    and matches the unsharded multi-chain kernel."""
    data, spec, pr, pi = build("BayesCpi", m=256)
    _, sam1, ex1 = G.run_chains(spec, data, pr, pi, seed=7, nchains=2)
    _, sam8, ex8 = G.run_chains(spec, data, pr, pi, seed=7, nchains=2,
                                mesh=make_mesh(8, shape=(8, 1)))
    vg1 = np.asarray(sam1["Vg"]).mean()
    vg8 = np.asarray(sam8["Vg"]).mean()
    assert abs(vg1 - vg8) / max(vg1, 1e-9) < 0.25
    a1 = np.asarray(sam1["alpha"]).mean(axis=(0, 1))
    a8 = np.asarray(sam8["alpha"]).mean(axis=(0, 1))
    assert np.corrcoef(a1, a8)[0, 1] > 0.95


def test_snp_sharded_kernel_statistical_chain():
    """Longer sharded-kernel chain agrees statistically with the unsharded
    kernel chain (posterior means within MC error)."""
    data, spec, pr, pi = build("BayesCpi", n=200, m=1024)
    kw = {**spec.__dict__}
    kw.update(niter=300, nburn=150)
    spec = G.GibbsSpec(**kw)
    _, s1, _ = G.run_chain(spec, data, pr, pi, seed=5)
    mesh = make_mesh(8, shape=(1, 8))
    _, s8, _ = G.run_chain(spec, data, pr, pi, seed=5, mesh=mesh)
    vg1, vg8 = float(np.mean(s1["Vg"])), float(np.mean(s8["Vg"]))
    assert abs(vg1 - vg8) / max(vg1, 1e-9) < 0.25
    a1 = np.mean(s1["alpha"], axis=0)
    a8 = np.mean(s8["alpha"], axis=0)
    assert np.corrcoef(a1, a8)[0, 1] > 0.95


# ---------------------------------------------------------------------------
# summary engine: SNP-sharded tiled sweep through the draws kernel
# ---------------------------------------------------------------------------


def build_tiled(model="BayesCpi", n=400, m=1024, B=128, guard=True, seed=3):
    from hibayes_tpu.data.sparse_ld import build_tiled_ld
    from tests.test_tiled_ld import _banded_geno, _sumstat

    X = _banded_geno(n=n, m=m, seed=seed)
    ss = _sumstat(X)
    tiled = build_tiled_ld(X, chisq=30.0, tile=B, stripe=2 * B,
                           dtype=np.float32)
    if model == "BayesR":
        nf, pi = 4, np.array([0.95, 0.02, 0.02, 0.01])
        fold = np.array([0.0, 1e-4, 1e-3, 1e-2])
    else:
        nf, pi, fold = 2, np.array([0.95, 0.05]), np.array([0.0, 1.0])
    data, n_eff, vary, nvar0, seg_sizes, seg_real = SG.prepare_sgibbs_data(
        ss, tiled, fold=fold, block=B, dtype=jnp.float32)
    pr = G.resolve_priors(None, float(np.sum(np.asarray(tiled.diag))), pi[0],
                          nr=0, vary=vary)
    spec = G.GibbsSpec(
        model=model, n=n_eff, m=m, m_pad=int(sum(seg_sizes)), block=B,
        nc=0, nlevels=(), n_fold=nf, niter=40, nburn=20, thin=5, nvar0=nvar0,
        dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare,
        s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0, vargl_strict_pos=True,
        real_excl_nvar0=True, reject_guard=guard, vary=vary, use_pallas=True,
        seg_sizes=seg_sizes, seg_real=seg_real, resync_every=0,
    )
    return data, spec, pr, pi


def s_one_iter(spec, data, state, mesh=None):
    if mesh is None:
        step = jax.jit(partial(SG.one_s_iteration, spec))
        return step(data, jax.random.PRNGKey(11), state)
    from hibayes_tpu.parallel.mesh import shard_sgibbs_data

    d = shard_sgibbs_data(data, mesh)
    with mesh:
        step = jax.jit(partial(SG.one_s_iteration, spec, mesh=mesh))
        return jax.block_until_ready(step(d, jax.random.PRNGKey(11), state))


@pytest.mark.parametrize("model,guard", [("BayesCpi", True), ("BayesR", False)])
def test_sbrm_tiled_snp_sharded_kernel_matches_unsharded(model, guard):
    """The sharded tiled sweep must run the draws kernel shard-locally (row
    offset against the full r_hat) and reproduce the unsharded kernel sweep,
    including the in-kernel rejection guard's retry stream."""
    data, spec, pr, pi = build_tiled(model, guard=guard)
    assert G._kernel_draws(spec, jnp.float32)
    s0 = SG.init_s_state(spec, data, pr, pi)
    s1 = s_one_iter(spec, data, s0)
    s8 = s_one_iter(spec, data, s0, mesh=make_mesh(8, shape=(1, 8)))
    assert_sweep_agrees(s1, s8)
    np.testing.assert_allclose(
        np.asarray(s1.r_hat), np.asarray(s8.r_hat), rtol=0,
        atol=1e-3 * np.abs(np.asarray(s1.r_hat)).max() + 1e-5,
    )


@pytest.mark.parametrize("Rm", [1, 2])
def test_sbrm_tiled_concurrent_schedule_runs(Rm):
    """Concurrent m-MP schedule for the tiled summary sweep: all shards
    sweep simultaneously against the round-start r_hat with Rm merges per
    iteration; the run must execute and stay statistically sane (a short
    chain's Vg close to the exact turn schedule's)."""
    import dataclasses

    data, spec, pr, pi = build_tiled("BayesCpi", m=2048, guard=True)
    spec_c = dataclasses.replace(spec, shard_schedule="concurrent",
                                 merge_rounds=Rm, niter=60, nburn=30)
    spec_t = dataclasses.replace(spec, niter=60, nburn=30)
    mesh = make_mesh(4, shape=(1, 4))
    from hibayes_tpu.parallel.mesh import shard_sgibbs_data

    _, s_t, _ = SG.run_s_chain(spec_t, data, pr, pi, seed=5, mesh=mesh)
    _, s_c, _ = SG.run_s_chain(spec_c, data, pr, pi, seed=5, mesh=mesh)
    a_t = np.asarray(s_t["alpha"]).mean(axis=0)
    a_c = np.asarray(s_c["alpha"]).mean(axis=0)
    assert np.isfinite(a_c).all()
    assert np.corrcoef(a_t, a_c)[0, 1] > 0.9
    vg_t = float(np.asarray(s_t["Vg"]).mean())
    vg_c = float(np.asarray(s_c["Vg"]).mean())
    assert abs(vg_t - vg_c) / max(vg_t, 1e-9) < 0.5


# ---------------------------------------------------------------------------
# ring-pipelined EXACT schedule (shard_schedule="pipeline")
# ---------------------------------------------------------------------------


def _pipeline_spec(spec, S, schedule_only=False):
    import dataclasses

    return dataclasses.replace(
        spec, shard_schedule="pipeline",
        emulate_shards=0 if schedule_only else S)


@pytest.mark.parametrize("model", ["BayesCpi", "BayesR"])
def test_pipeline_group0_bitmatches_unsharded(model):
    """Chain group 0 of the pipelined schedule sweeps the canonical block
    order, so its chains must reproduce the unsharded batched kernel sweep
    bit-for-bit (same RNG streams); groups 1.. run rotated orders and are
    intentionally different (but finite) draws."""
    data, spec, pr, pi = build(model)
    S, K = 4, 4
    states, keys = _batched(spec, data, pr, pi, K)
    s1 = batch_one_iter(spec, data, states, keys)
    spec_p = _pipeline_spec(spec, S, schedule_only=True)
    s8 = batch_one_iter(spec_p, data, states, keys,
                        mesh=make_mesh(4, shape=(1, 4)))
    row = lambda s: jax.tree_util.tree_map(lambda x: np.asarray(x)[0], s)
    assert_sweep_agrees(row(s1), row(s8))
    assert np.isfinite(np.asarray(s8.g)).all()
    assert np.isfinite(np.asarray(s8.vare)).all()


def test_pipeline_emulation_matches_distributed():
    """The single-device pipeline emulation runs the identical Markov kernel
    as the 4-shard distributed pipeline — every chain agrees."""
    data, spec, pr, pi = build("BayesCpi")
    S, K = 4, 8
    states, keys = _batched(spec, data, pr, pi, K)
    spec_d = _pipeline_spec(spec, S, schedule_only=True)
    s_d = batch_one_iter(spec_d, data, states, keys,
                         mesh=make_mesh(4, shape=(1, 4)))
    spec_e = _pipeline_spec(spec, S)
    s_e = batch_one_iter(spec_e, data, states, keys)
    assert_sweep_agrees(s_e, s_d)


def test_pipeline_chain_statistical():
    """A pipelined multi-chain run agrees statistically with the plain
    multi-chain run (every chain is an exact Gibbs scan, merely in a
    rotated block order)."""
    data, spec, pr, pi = build("BayesCpi", n=200, m=1024)
    kw = {**spec.__dict__}
    kw.update(niter=300, nburn=150)
    spec = G.GibbsSpec(**kw)
    _, s1, _ = G.run_chains(spec, data, pr, pi, seed=5, nchains=4)
    spec_p = _pipeline_spec(spec, 4, schedule_only=True)
    mesh = make_mesh(4, shape=(1, 4))
    _, s8, _ = G.run_chains(spec_p, data, pr, pi, seed=5, nchains=4, mesh=mesh)
    vg1 = float(np.mean(np.asarray(s1["Vg"])))
    vg8 = float(np.mean(np.asarray(s8["Vg"])))
    assert abs(vg1 - vg8) / max(vg1, 1e-9) < 0.25
    a1 = np.asarray(s1["alpha"]).mean(axis=(0, 1))
    a8 = np.asarray(s8["alpha"]).mean(axis=(0, 1))
    assert np.corrcoef(a1, a8)[0, 1] > 0.95


def test_sbrm_tiled_pipeline_raises():
    """The summary engine has no pipeline schedule — must fail loudly, not
    silently run the turn loop."""
    import dataclasses

    data, spec, pr, pi = build_tiled("BayesCpi", m=2048, guard=True)
    spec_p = dataclasses.replace(spec, shard_schedule="pipeline",
                                 niter=4, nburn=2)
    mesh = make_mesh(4, shape=(1, 4))
    with pytest.raises(ValueError, match="pipeline"):
        SG.run_s_chain(spec_p, data, pr, pi, seed=5, mesh=mesh)


def test_pipeline_requires_chain_multiple():
    """K not a multiple of S must fail loudly."""
    data, spec, pr, pi = build("BayesCpi")
    states, keys = _batched(spec, data, pr, pi, 3)
    spec_p = _pipeline_spec(spec, 4, schedule_only=True)
    with pytest.raises(ValueError, match="multiple"):
        batch_one_iter(spec_p, data, states, keys,
                       mesh=make_mesh(4, shape=(1, 4)))
