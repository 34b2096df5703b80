"""Posterior-agreement study: concurrent-shard schedule vs the exact chain
at synthetic scale n=4096 x m=65,536.

Runs the exact single-device chain and the S=8 concurrent emulation (the
SAME Markov kernel as an 8-device distributed concurrent run) for full
chains, then compares GEBV correlation, variance components (within the
exact chain's Monte-Carlo error) and per-SNP effect correlation.

Usage: python benchmarks/concurrent_accuracy_study.py [quick] [model]
"""

import dataclasses
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from hibayes_tpu import runtime
from hibayes_tpu.engine import gibbs as G


def _sim_geno(rng, n, m, maf=0.3):
    p0 = (1 - maf) ** 2
    p1 = 2 * maf * (1 - maf)
    raw = rng.integers(0, 256, size=(n, m), dtype=np.uint8)
    out = np.ones((n, m), dtype=np.int8)
    out[raw < int(p0 * 256)] = 0
    out[raw >= int((p0 + p1) * 256)] = 2
    return out


def run(model="BayesCpi", n=4096, m=65_536, niter=3000, nburn=1500,
        S=8, Rm=1, seed=17):
    rng = np.random.default_rng(0)
    M = _sim_geno(rng, n, m)
    # sparse architecture: 1% causal SNPs, h2 ~= 0.5
    causal = rng.random(m) < 0.01
    b = np.where(causal, rng.normal(0, 1.0, m), 0.0).astype(np.float32)
    gtrue = M.astype(np.float32) @ b
    gtrue /= gtrue.std()
    y = (np.sqrt(0.5) * gtrue + np.sqrt(0.5) * rng.normal(0, 1, n)).astype(np.float32)

    if model == "BayesR":
        pi = np.array([0.95, 0.02, 0.02, 0.01])
        fold = np.array([0.0, 1e-4, 1e-3, 1e-2])
    else:
        pi, fold = np.array([0.95, 0.05]), None

    def fit(schedule, emu, Rm_):
        data = G.prepare_gibbs_data(
            y, M, block=128, dtype=jnp.float32, geno_dtype="int8", fold=fold,
            nblocks_multiple=(emu * Rm_) if emu else 1)
        pr = G.resolve_priors(y, float(np.asarray(data.vx).sum()), pi[0], nr=0)
        spec = G.GibbsSpec(
            model=model, n=n, m=m, m_pad=int(data.xpx.shape[0]), block=128,
            nc=0, nlevels=(), n_fold=len(pi), niter=niter, nburn=nburn,
            thin=5, nvar0=int((np.asarray(data.vx)[:m] == 0).sum()),
            dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare,
            s2vare=pr.s2vare, s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0,
            use_pallas=runtime.use_kernels(),
            shard_schedule=schedule, emulate_shards=emu, merge_rounds=Rm_,
        )
        t0 = time.time()
        _, s, ex = G.run_chain(spec, data, pr, pi, seed=seed)
        dt = time.time() - t0
        return s, ex, dt

    s_x, ex_x, t_x = fit("turn", 0, 1)
    print(f"exact chain: {t_x:.1f}s", flush=True)
    s_c, ex_c, t_c = fit("concurrent", S, Rm)
    print(f"concurrent emu S={S} Rm={Rm}: {t_c:.1f}s", flush=True)

    ax = np.asarray(s_x["alpha"]).mean(axis=0)
    ac = np.asarray(s_c["alpha"]).mean(axis=0)
    Mf = M.astype(np.float32)
    gx, gc = Mf @ ax, Mf @ ac
    corr_g = np.corrcoef(gx, gc)[0, 1]
    corr_a = np.corrcoef(ax, ac)[0, 1]
    acc_x = np.corrcoef(gx, gtrue)[0, 1]
    acc_c = np.corrcoef(gc, gtrue)[0, 1]
    print(f"{model} n={n} m={m} S={S} Rm={Rm}: GEBV corr(exact, concurrent) "
          f"= {corr_g:.5f}; alpha corr = {corr_a:.4f}", flush=True)
    print(f"  prediction accuracy vs truth: exact {acc_x:.4f}, "
          f"concurrent {acc_c:.4f}", flush=True)
    for k in ("Vg", "Ve", "h2"):
        mx = float(np.asarray(s_x[k]).mean())
        sx = float(np.asarray(s_x[k]).std())
        mc = float(np.asarray(s_c[k]).mean())
        z = (mc - mx) / max(sx, 1e-12)
        print(f"  {k}: exact {mx:.4f} (sd {sx:.4f})  concurrent {mc:.4f}  "
              f"z={z:+.2f}", flush=True)
    pip_x, pip_c = np.asarray(ex_x["pip"]), np.asarray(ex_c["pip"])
    print(f"  PIP corr = {np.corrcoef(pip_x, pip_c)[0, 1]:.4f}", flush=True)
    return corr_g


def run_pipeline(model="BayesCpi", n=4096, m=65_536, niter=1000, nburn=500,
                 S=8, K=8, seed=17):
    """Exactness demonstration for the ring-pipelined schedule at study
    scale: run K chains unsharded and K chains under the S-shard pipeline
    emulation with the same seed.  Every chain samples the same posterior
    (group 0 even sweeps the canonical order — one-STEP bit equality is
    asserted in tests/test_sharded_kernels.py; over a full chain f32
    association-order differences between the K-lane and Kg-lane kernels
    decorrelate trajectories, as for any exact implementation pair), so
    ensemble moments must agree within Monte-Carlo error — unlike the
    concurrent schedule's systematic bias."""
    rng = np.random.default_rng(0)
    M = _sim_geno(rng, n, m)
    causal = rng.random(m) < 0.01
    b = np.where(causal, rng.normal(0, 1.0, m), 0.0).astype(np.float32)
    gtrue = M.astype(np.float32) @ b
    gtrue /= gtrue.std()
    y = (np.sqrt(0.5) * gtrue
         + np.sqrt(0.5) * rng.normal(0, 1, n)).astype(np.float32)
    pi, fold = np.array([0.95, 0.05]), None

    def fit(schedule, emu):
        data = G.prepare_gibbs_data(
            y, M, block=128, dtype=jnp.float32, geno_dtype="int8", fold=fold,
            nblocks_multiple=S)
        pr = G.resolve_priors(y, float(np.asarray(data.vx).sum()), pi[0], nr=0)
        spec = G.GibbsSpec(
            model=model, n=n, m=m, m_pad=int(data.xpx.shape[0]), block=128,
            nc=0, nlevels=(), n_fold=len(pi), niter=niter, nburn=nburn,
            thin=5, nvar0=int((np.asarray(data.vx)[:m] == 0).sum()),
            dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare,
            s2vare=pr.s2vare, s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0,
            use_pallas=runtime.use_kernels(),
            shard_schedule=schedule, emulate_shards=emu,
        )
        t0 = time.time()
        _, s, _ = G.run_chains(spec, data, pr, pi, seed=seed, nchains=K)
        return s, time.time() - t0

    s_x, t_x = fit("turn", 0)
    print(f"unsharded {K}-chain: {t_x:.1f}s", flush=True)
    s_p, t_p = fit("pipeline", S)
    print(f"pipeline emu S={S} {K}-chain: {t_p:.1f}s", flush=True)
    a_x0 = np.asarray(s_x["alpha"])[0].mean(axis=0)
    a_p0 = np.asarray(s_p["alpha"])[0].mean(axis=0)
    d0 = np.abs(a_x0 - a_p0).max()
    print(f"{model}: chain-0 (canonical order) max |d alpha-mean| = {d0:.2e} "
          f"(MC-error level; one-step bit equality asserted in tests)",
          flush=True)
    Mf = M.astype(np.float32)
    gx = Mf @ np.asarray(s_x["alpha"]).mean(axis=(0, 1))
    gp = Mf @ np.asarray(s_p["alpha"]).mean(axis=(0, 1))
    print(f"{model}: ensemble GEBV corr(unsharded, pipeline) = "
          f"{np.corrcoef(gx, gp)[0, 1]:.5f}", flush=True)
    for k in ("Vg", "Ve", "h2"):
        mx = float(np.asarray(s_x[k]).mean())
        sx = float(np.asarray(s_x[k]).std())
        mp_ = float(np.asarray(s_p[k]).mean())
        print(f"  {k}: unsharded {mx:.4f} (sd {sx:.4f})  pipeline {mp_:.4f}  "
              f"z={(mp_-mx)/max(sx,1e-12):+.2f}", flush=True)


if __name__ == "__main__":
    quick = "quick" in sys.argv
    models = [a for a in sys.argv[1:] if a in ("BayesCpi", "BayesR")] or \
        (["BayesCpi"] if quick else ["BayesCpi", "BayesR"])
    if "pipeline" in sys.argv:
        for mod in models:
            run_pipeline(model=mod, niter=1000 if quick else 3000,
                         nburn=500 if quick else 1500)
    else:
        for mod in models:
            run(model=mod, niter=1000 if quick else 3000,
                nburn=500 if quick else 1500)
