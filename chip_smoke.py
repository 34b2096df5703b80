#!/usr/bin/env python3
"""Chip smoke test: drive ibrm / ldmat / sbrm / ssbrm once on an NVIDIA GPU.

    python chip_smoke.py                 # phases 0-5 on one GPU
    python chip_smoke.py --four-cards    # phase 6 only: meshes over 4 GPUs

Seeded synthetic data, nothing downloaded, one process.  Every phase prints
one line `[phase] seconds=... path=... <results>`; any failed check raises,
so the script exits non-zero and never prints the closing JSON line.  The
last line of a passing run is
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Tolerances for kernel-vs-reference comparisons (one step from the same
state, f32, different summation orders): spike/slab/fold indicators agree on
>= 99% of SNPs (a last-bit difference can flip a discrete draw); where they
agree |dg| <= 5e-5 max|g|; yadj relative L2 <= 1e-4 when all agree.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time

import numpy as np

FLIP_MIN_AGREE = 0.99
G_ATOL = 5e-5
YADJ_RTOL = 1e-4

FULL = dict(
    n_anchor=50_000, m=65_536, n_mc=4_096, nchains=64, n_ld=2_000,
    m_dense=8_192, n_ped=20_000, n_geno=5_000, n_phen=12_000, m_ss=8_192,
    block=128, niter=40, nburn=20, reps=5, mme_T=128, check_fit=True)


class CheckFailed(AssertionError):
    pass


def check(ok, what):
    if not ok:
        raise CheckFailed(what)


def phase(name):
    """Decorator: time a phase and print its one-line report."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*a, **k):
            t0 = time.perf_counter()
            res = fn(*a, **k)
            fields = " ".join(f"{key}={val}" for key, val in res.items())
            print(f"[{name}] seconds={time.perf_counter() - t0:.1f} {fields}",
                  flush=True)
            return res
        return run
    return wrap


def timed(fn, *args, reps=5):
    """(result, median seconds) of fn(*args) after one warm call."""
    import jax

    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, float(np.median(ts))


def compare_step(ref, test, yadj=True):
    """Section-4 agreement of two one-step outputs (g, track[, yadj])."""
    tr_r, tr_t = np.asarray(ref.track), np.asarray(test.track)
    agree = tr_r == tr_t
    g_r, g_t = np.asarray(ref.g, np.float64), np.asarray(test.g, np.float64)
    scale = np.abs(g_r).max() + 1e-30
    err = (np.abs(g_r - g_t)[agree].max() / scale) if agree.any() else 0.0
    out = {"agree": float(agree.mean()), "g_err": float(err)}
    check(agree.mean() >= FLIP_MIN_AGREE, f"indicator agreement {agree.mean()}")
    check(err <= G_ATOL, f"g error {err} > {G_ATOL} max|g|")
    if yadj and hasattr(ref, "yadj"):
        y_r = np.asarray(ref.yadj, np.float64)
        y_t = np.asarray(test.yadj, np.float64)
        rel = float(np.linalg.norm(y_r - y_t) / (np.linalg.norm(y_r) + 1e-30))
        out["yadj_rel"] = rel
        if agree.all():
            check(rel <= YADJ_RTOL, f"yadj rel L2 {rel} > {YADJ_RTOL}")
    return out


def fmt(d):
    return {k: (f"{v:.3g}" if isinstance(v, float) else v) for k, v in d.items()}


# ---------------------------------------------------------------------------
# seeded synthetic data (generated on the device, in bulk)
# ---------------------------------------------------------------------------


def sim_genotype(key, n, m, chunk=8_192):
    """int8 (n, m) genotypes, binomial(2, p_j) with p_j ~ U(0.05, 0.5)."""
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnums=1)
    def cols(k, m_c):
        kp, k1, k2 = jax.random.split(k, 3)
        p = jax.random.uniform(kp, (m_c,), minval=0.05, maxval=0.5)
        a = jax.random.uniform(k1, (n, m_c)) < p
        b = jax.random.uniform(k2, (n, m_c)) < p
        return a.astype(jnp.int8) + b.astype(jnp.int8)

    out = np.empty((n, m), np.int8)
    for i, c0 in enumerate(range(0, m, chunk)):
        c1 = min(m, c0 + chunk)
        out[:, c0:c1] = np.asarray(cols(jax.random.fold_in(key, i), c1 - c0))
    return out


def genetic_value(M, beta, chunk=8_192):
    """M @ beta on the device (f32, exact int8 upcast), column chunks."""
    import jax
    import jax.numpy as jnp

    g = jnp.zeros((M.shape[0],), jnp.float32)
    for c0 in range(0, M.shape[1], chunk):
        blk = jnp.asarray(M[:, c0:c0 + chunk]).astype(jnp.float32)
        g = g + jnp.matmul(blk, jnp.asarray(beta[c0:c0 + chunk], jnp.float32),
                           precision=jax.lax.Precision.HIGHEST)
    return np.asarray(g, np.float64)


def sim_cohort(seed, n, m, h2=0.5, n_causal=500):
    """Genotypes, phenotype y = g + x1 + group + e and the true g."""
    import jax

    rng = np.random.default_rng(seed)
    M = sim_genotype(jax.random.PRNGKey(seed), n, m)
    beta = np.zeros(m)
    causal = rng.choice(m, min(n_causal, m // 4), replace=False)
    beta[causal] = rng.normal(size=len(causal))
    g = genetic_value(M, beta)
    g = (g - g.mean()) * np.sqrt(h2 / g.var())
    x1 = rng.normal(size=n)
    grp = rng.integers(0, 20, n)
    y = 10.0 + g + 0.3 * x1 + 0.2 * rng.normal(size=20)[grp] \
        + rng.normal(0, np.sqrt(1 - h2), n)
    ids = np.array([f"i{i}" for i in range(n)])
    data = {"id": ids, "y": y, "x1": x1, "grp": np.array([f"g{k}" for k in grp])}
    return M, ids, data, g


def gebv_corr(fit, ids, g_true):
    """Correlation of a fit's GEBV with the simulated genetic values."""
    pos = {k: i for i, k in enumerate(fit.g["id"])}
    gebv = np.asarray(fit.g["gebv"])[[pos[i] for i in ids]]
    return float(np.corrcoef(gebv, g_true)[0, 1])


def engine_problem(M, y, model, block, nchains=1):
    """Engine-level data/spec for one-step timing and comparisons."""
    import jax.numpy as jnp

    from hibayes_tpu import runtime
    from hibayes_tpu.engine import gibbs as G

    if model == "BayesR":
        pi = np.array([0.95, 0.02, 0.02, 0.01])
        fold = np.array([0.0, 1e-4, 1e-3, 1e-2])
    else:
        pi, fold = np.array([0.95, 0.05]), None
    n, m = M.shape
    data = G.prepare_gibbs_data(y, M, block=block, dtype=jnp.float32,
                                geno_dtype="int8", fold=fold)
    pr = G.resolve_priors(y, float(np.asarray(data.vx).sum()), pi[0], nr=0)
    spec = G.GibbsSpec(
        model=model, n=n, m=m, m_pad=int(data.xpx.shape[0]), block=block,
        nc=0, nlevels=(), n_fold=len(pi), niter=100, nburn=50, thin=5,
        nvar0=int((np.asarray(data.vx)[:m] == 0).sum()),
        dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare,
        s2vare=pr.s2vare, s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0,
        use_pallas=runtime.use_kernels())
    return G, data, spec, pr, pi


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def draw_path(model, block):
    """The sweep path a front-end takes for this method and block: the
    draws kernel or the per-SNP XLA scan (`engine.gibbs._kernel_draws` on a
    spec flagged by `runtime.use_kernels()`, as every front-end flags it)."""
    import jax.numpy as jnp

    from hibayes_tpu import runtime
    from hibayes_tpu.engine import gibbs as G

    spec = G.GibbsSpec(
        model=model, n=1, m=block, m_pad=block, block=block, nc=0,
        nlevels=(), n_fold=2, niter=1, nburn=0, thin=1, nvar0=0,
        use_pallas=runtime.use_kernels())
    path = "kernels" if G._kernel_draws(spec, jnp.float32) else "xla-scan"
    check(path == "kernels", f"{model} block={block} takes the XLA scan")
    return path


@phase("phase0 device")
def phase0():
    import jax

    from hibayes_tpu import runtime

    dev = jax.devices()[0]
    check(dev.platform == "gpu", f"no GPU: JAX platform is {dev.platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    return {"jax": jax.__version__, "kind": repr(dev.device_kind),
            "count": len(jax.devices()), "card": repr(smi[0]),
            "compile_cache": runtime.configure_compile_cache(),
            "path": "kernels" if runtime.use_kernels() else "xla"}


@phase("phase1 kernels")
def phase1(S):
    """Draws kernel vs the per-SNP scan at B=128, K in {1, 64}, every
    method; the guarded kernel vs its f64 oracle; the MME kernel vs the
    site scan at T=128.  Times are the per-block draws alone."""
    import jax
    import jax.numpy as jnp

    from hibayes_tpu.ops import blockgibbs as BG
    from tests.oracle import guarded_draws_oracle
    from tests.test_draws_kernel import (
        MODELS, make_block, mme_problem, mme_scan, packed_rows, scan_draws)

    def per_block(draw, r0, nb=32):
        """Seconds per block of draw(r0) -> (dg (B, K), track) inside one
        compiled scan of nb blocks (a single call would time dispatch)."""
        def many(r0):
            def body(c, _):
                dg, _ = draw(r0 + c)
                return c + 0.0 * dg, None
            return jax.lax.scan(body, jnp.zeros_like(r0), None, length=nb)[0]

        return timed(jax.jit(many), r0, reps=S["reps"])[1] / nb

    res = {}
    draws = jax.jit(BG.block_draws, static_argnums=0)
    for model in MODELS:
        for K in (1, S["nchains"]):
            spec, consts, pc, sh = make_block(model, K, B=S["block"], seed=K)
            P = packed_rows(spec, consts, pc, sh)
            P_b = BG.to_block_layout(P, 1, spec.block)[0]
            dg, tr = draws(spec, P_b, sh["W"], pc["r0"])
            dg_r, tr_r = scan_draws(spec, consts, pc, sh)
            t_k = per_block(
                lambda r0: BG.block_draws(spec, P_b, sh["W"], r0), pc["r0"])
            t_s = per_block(lambda r0: tuple(a.T for a in scan_draws(
                spec, consts, dict(pc, r0=r0), sh)), pc["r0"])
            agree = np.asarray(tr).T == np.asarray(tr_r)
            g_new = np.asarray(pc["g"]) - np.asarray(dg_r)
            err = (np.abs(np.asarray(dg).T - np.asarray(dg_r))[agree].max()
                   / (np.abs(g_new).max() + 1e-30))
            check(agree.mean() >= FLIP_MIN_AGREE, f"{model} K={K} flips")
            check(err <= G_ATOL, f"{model} K={K} dg err {err}")
            res[f"{model}_K{K}"] = (f"err={err:.2g}/agree={agree.mean():.4f}/"
                                    f"kernel_us={1e6 * t_k:.1f}/"
                                    f"scan_us={1e6 * t_s:.1f}")
    for model in ("BayesCpi", "BayesR"):
        spec, consts, pc, sh = make_block(model, 4, B=S["block"], seed=21,
                                          guard=True, vary=2e-3)
        zr = jax.random.normal(jax.random.PRNGKey(3),
                               (4, BG.N_RETRY, S["block"]), jnp.float32)
        P = packed_rows(spec, consts, pc, sh, zr)
        P_b = BG.to_block_layout(P, 1, spec.block)[0]
        dg, tr = draws(spec, P_b, sh["W"], pc["r0"])
        dg_o, tr_o, n_rej = guarded_draws_oracle(
            spec, np.asarray(P), np.asarray(sh["W"]), np.asarray(pc["r0"]).T)
        agree = np.asarray(tr).T == tr_o
        err = (np.abs(np.asarray(dg).T - dg_o)[agree].max()
               / (np.abs(np.asarray(pc["g"]) - dg_o).max() + 1e-30))
        check(n_rej > 0 and agree.mean() >= FLIP_MIN_AGREE and err <= G_ATOL,
              f"guard {model}: rej={n_rej} agree={agree.mean()} err={err}")
        res[f"guard_{model}"] = f"err={err:.2g}/rejections={n_rej}"
    W, r0, invd, noise = (jnp.asarray(a, jnp.float32)
                          for a in mme_problem(S["mme_T"]))
    dx = BG.mme_block_draws(W, r0, invd, noise)
    dx_r = mme_scan(W, r0, invd, noise)
    t_k = per_block(lambda r: (BG.mme_block_draws(W, r, invd, noise), None), r0)
    t_s = per_block(lambda r: (mme_scan(W, r, invd, noise), None), r0)
    err = float(np.abs(np.asarray(dx) - np.asarray(dx_r)).max()
                / np.abs(np.asarray(dx_r)).max())
    check(err <= 1e-5, f"mme err {err}")
    res["mme_T128"] = (f"err={err:.2g}/kernel_us={1e6 * t_k:.1f}/"
                       f"scan_us={1e6 * t_s:.1f}")
    return res


def bind(fn, data):
    """jit fn(data, state) and bind the data as an argument: a closure over
    device arrays would embed them in the program as constants."""
    import jax

    return functools.partial(jax.jit(fn), data)


def step_compare(G, data, spec, pr, pi, reps, label, batch=0):
    """Compile the kernel step and the XLA-scan step, time both, and
    compare one iteration from a fixed state (after 3 kernel steps)."""
    import dataclasses

    import jax

    key = jax.random.PRNGKey(5)
    s0 = G.init_state(spec, data, pr, pi)
    if batch:
        keys = jax.random.split(key, batch)
        s0 = jax.tree_util.tree_map(
            lambda x: jax.numpy.broadcast_to(x, (batch,) + x.shape), s0)
        mk = lambda sp: jax.jit(
            lambda d, s: G.one_iteration_batch(sp, d, keys, s))
    else:
        mk = lambda sp: jax.jit(lambda d, s: G.one_iteration(sp, d, key, s))
    out = {}
    t0 = time.perf_counter()
    compiled = mk(spec).lower(data, s0).compile()
    out[f"{label}_compile_s"] = round(time.perf_counter() - t0, 1)
    ma = compiled.memory_analysis()
    if ma is not None:
        out[f"{label}_temp_MB"] = round(ma.temp_size_in_bytes / 2**20, 1)
        out[f"{label}_args_MB"] = round(ma.argument_size_in_bytes / 2**20, 1)
    s = s0
    for _ in range(3):
        s = compiled(data, s)
    s_fixed = jax.block_until_ready(s)
    _, t_k = timed(compiled, data, s_fixed, reps=reps)
    out[f"{label}_kernel_ms_per_iter"] = round(1e3 * t_k, 2)
    spec_x = dataclasses.replace(spec, use_pallas=False)
    t0 = time.perf_counter()
    compiled_x = mk(spec_x).lower(data, s0).compile()
    out[f"{label}_xla_compile_s"] = round(time.perf_counter() - t0, 1)
    ref, t_x = timed(compiled_x, data, s_fixed, reps=max(1, min(reps, 2)))
    out[f"{label}_xla_ms_per_iter"] = round(1e3 * t_x, 2)
    got = compiled(data, s_fixed)
    out.update({f"{label}_{k}": v for k, v in
                fmt(compare_step(ref, got)).items()})
    return out


@phase("phase2 ibrm")
def phase2(S):
    """ibrm BayesR, single chain, int8 n x m at the round-5 cohort shape."""
    import hibayes_tpu as ht

    n, m = S["n_anchor"], S["m"]
    M, ids, data, g_true = sim_cohort(1, n, m)
    t0 = time.perf_counter()
    fit = ht.ibrm("y ~ x1 + (1|grp)", data=data, M=M, M_id=ids,
                  method="BayesR", block=S["block"], niter=S["niter"],
                  nburn=S["nburn"], thin=5, verbose=False, printfreq=0)
    t_fit = time.perf_counter() - t0
    h2, corr = float(fit.h2), gebv_corr(fit, ids, g_true)
    check(np.isfinite(h2) and np.isfinite(corr), f"h2 {h2}, GEBV corr {corr}")
    if S["check_fit"]:
        check(0.2 < h2 < 0.8, f"h2 {h2} (simulated 0.5)")
        check(corr > 0.5, f"GEBV corr {corr}")
    out = {"path": "ibrm/" + draw_path("BayesR", S["block"]), "n": n, "m": m,
           "fit_s": round(t_fit, 1), "h2": round(h2, 4),
           "gebv_corr": round(corr, 4)}
    G, data_e, spec, pr, pi = engine_problem(M, data["y"], "BayesR", S["block"])
    out.update(step_compare(G, data_e, spec, pr, pi, S["reps"], "step"))
    return out


@phase("phase3 ibrm chains")
def phase3(S):
    """ibrm BayesCpi with K chains (the multi-chain bench shape)."""
    import hibayes_tpu as ht

    n, m, K = S["n_mc"], S["m"], S["nchains"]
    M, ids, data, _ = sim_cohort(2, n, m)
    niter, nburn = 30, 10
    kw = dict(data=data, M=M, M_id=ids, method="BayesCpi", block=S["block"],
              niter=niter, nburn=nburn, thin=5, verbose=False, printfreq=0,
              nchains=K)
    t0 = time.perf_counter()
    fit = ht.ibrm("y ~ x1", seed=1, **kw)
    t1 = time.perf_counter()
    fit2 = ht.ibrm("y ~ x1", seed=2, **kw)
    t2 = time.perf_counter()
    rh = fit2.rhat or {}
    check(np.isfinite(rh.get("Vg", np.nan)) and np.isfinite(rh.get("h2", np.nan)),
          f"split-R-hat not finite: {rh}")
    check(np.isfinite(fit.h2), "h2 not finite")
    out = {"path": "ibrm/" + draw_path("BayesCpi", S["block"]), "n": n,
           "m": m, "chains": K,
           "first_call_s": round(t1 - t0, 1),
           "ms_per_iter": round(1e3 * (t2 - t1) / niter, 2),
           "rhat_Vg": round(rh["Vg"], 3), "rhat_h2": round(rh["h2"], 3)}
    G, data_e, spec, pr, pi = engine_problem(M, data["y"], "BayesCpi", S["block"])
    out.update(step_compare(G, data_e, spec, pr, pi, S["reps"], "step",
                            batch=K))
    return out


def banded_genotype(seed, n, m, copy_p=0.55):
    """int8 genotypes with local LD: each SNP copies its left neighbour in a
    random ~copy_p of individuals (correlation decays geometrically)."""
    rng = np.random.default_rng(seed)
    X = rng.binomial(2, 0.4, size=(n, m)).astype(np.int8)
    copy = rng.random((n, m)) < copy_p
    for j in range(1, m):
        X[copy[:, j], j] = X[copy[:, j], j - 1]
    return X


def sumstats(X, seed, h2=0.4):
    """Marginal GWAS statistics [MAF, BETA, SE, N] simulated from the panel."""
    rng = np.random.default_rng(seed)
    n, m = X.shape
    Xf = X.astype(np.float32)
    mu = Xf.mean(0)
    b = rng.normal(0, 1, m) * (rng.random(m) < 0.01)
    gval = (Xf - mu) @ b
    gval *= np.sqrt(h2 / max(gval.var(), 1e-12))
    y = gval + rng.normal(0, np.sqrt(1 - h2), n)
    vx = Xf.var(0)
    beta = ((Xf - mu).T @ (y - y.mean())) / n / np.maximum(vx, 1e-12)
    se = np.sqrt(np.maximum(y.var() - beta**2 * vx, 1e-6)
                 / (np.maximum(vx, 1e-12) * (n - 2)))
    maf = np.minimum(mu / 2, 1 - mu / 2)
    return np.column_stack([maf, beta, se, np.full(m, n)])


@phase("phase4 sbrm")
def phase4(S):
    """ldmat tiled LD from seeded genotypes, sbrm BayesCpi on it, and one
    dense chromosome-block LD fit (the segment path)."""
    import dataclasses

    import jax

    import hibayes_tpu as ht
    from hibayes_tpu import runtime
    from hibayes_tpu.engine import gibbs as G
    from hibayes_tpu.engine import sgibbs as SG

    n, m, B = S["n_ld"], S["m"], S["block"]
    X = banded_genotype(3, n, m)
    ss = sumstats(X, 4)
    t0 = time.perf_counter()
    ld = ht.ldmat(X, chisq=30.0, tiled=True, tile=B, stripe=4096)
    t_ld = time.perf_counter() - t0
    out = {"path": "sbrm/tiled/" + draw_path("BayesCpi", ld.tile), "n": n,
           "m": m,
           "ldmat_s": round(t_ld, 1), "tiles": int(ld.valid.sum()),
           "k_max": int(ld.tiles.shape[1])}
    t0 = time.perf_counter()
    fit = ht.sbrm(ss, ld, method="BayesCpi", niter=S["niter"],
                  nburn=S["nburn"], verbose=False, printfreq=0)
    out["sbrm_s"] = round(time.perf_counter() - t0, 1)
    check(np.isfinite(fit.h2) and 0 <= fit.h2 < 1, f"sbrm h2 {fit.h2}")
    out["h2"] = round(float(fit.h2), 4)

    # one step of the tiled sweep, kernel vs XLA scan, from a fixed state
    # (guard off on both sides: its bounded retries differ by design)
    data, n_eff, vary, nvar0, seg_sizes, seg_real = SG.prepare_sgibbs_data(
        ss, ld, fold=np.zeros(2), block=B)
    pr = G.resolve_priors(None, float(np.sum(np.asarray(ld.diag))), 0.95,
                          nr=0, vary=vary)
    spec = G.GibbsSpec(
        model="BayesCpi", n=n_eff, m=m, m_pad=int(sum(seg_sizes)), block=B,
        nc=0, nlevels=(), n_fold=2, niter=10, nburn=5, thin=1, nvar0=nvar0,
        dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare,
        s2vare=pr.s2vare, s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0,
        vargl_strict_pos=True, real_excl_nvar0=True, vary=vary,
        seg_sizes=seg_sizes, seg_real=seg_real,
        use_pallas=runtime.use_kernels())
    key = jax.random.PRNGKey(7)
    s = SG.init_s_state(spec, data, pr, np.array([0.95, 0.05]))
    step_k = bind(lambda d, st: SG.one_s_iteration(spec, d, key, st), data)
    step_x = bind(lambda d, st: SG.one_s_iteration(
        dataclasses.replace(spec, use_pallas=False), d, key, st), data)
    for _ in range(3):
        s = step_k(s)
    got, t_k = timed(step_k, s, reps=S["reps"])
    ref, t_x = timed(step_x, s, reps=1)
    out.update({f"step_{k}": v for k, v in fmt(compare_step(ref, got)).items()})
    out["step_kernel_ms_per_iter"] = round(1e3 * t_k, 2)
    out["step_xla_ms_per_iter"] = round(1e3 * t_x, 2)

    # dense chromosome-block LD: 4 chromosomes, one segment each
    md = S["m_dense"]
    Xd = X[:, :md]
    chrom = np.repeat(np.arange(1, 5), md // 4).astype(str)
    map_ = {"SNP": np.array([f"s{j}" for j in range(md)]), "Chr": chrom,
            "Pos": np.arange(md, dtype=float)}
    ld_d = ht.ldmat(Xd, map=map_)
    t0 = time.perf_counter()
    fit_d = ht.sbrm(sumstats(Xd, 5), ld_d, method="BayesCpi",
                    niter=S["niter"], nburn=S["nburn"], block=B,
                    verbose=False, printfreq=0)
    out["dense_path"] = "sbrm/segments/" + draw_path("BayesCpi", B)
    out["dense_blocks"] = type(ld_d).__name__
    out["dense_sbrm_s"] = round(time.perf_counter() - t0, 1)
    check(np.isfinite(fit_d.h2) and 0 <= fit_d.h2 < 1, f"dense h2 {fit_d.h2}")
    out["dense_h2"] = round(float(fit_d.h2), 4)
    return out


def random_pedigree(seed, n_ids, n_found):
    """Founders then offspring whose parents are earlier ids."""
    rng = np.random.default_rng(seed)
    ids = np.array([f"a{i}" for i in range(n_ids)])
    sires = np.full(n_ids, "0", dtype=object)
    dams = np.full(n_ids, "0", dtype=object)
    for k in range(n_found, n_ids):
        s, d = rng.integers(0, k, 2)
        sires[k], dams[k] = ids[s], ids[d]
    return ids, sires.astype(str), dams.astype(str)


@phase("phase5 ssbrm")
def phase5(S):
    """ssbrm with PCG imputation on a seeded pedigree; the epsilon sweep's
    MME kernel vs the site scan on that pedigree's A-inverse."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp

    import hibayes_tpu as ht
    from hibayes_tpu import runtime
    from hibayes_tpu.data.pedigree import make_ainv, make_ped, rcm_permutation
    from hibayes_tpu.engine.gibbs import (
        _build_epsl_sparse, blocked_mme_gibbs_sparse)
    from hibayes_tpu.ops import blockgibbs as BG

    rng = np.random.default_rng(6)
    n_ids, n_g, m = S["n_ped"], S["n_geno"], S["m_ss"]
    ids, sires, dams = random_pedigree(6, n_ids, n_ids // 10)
    geno_ids = rng.choice(ids[n_ids // 10:], n_g, replace=False)
    M = sim_genotype(jax.random.PRNGKey(6), n_g, m)
    phe_ids = rng.choice(ids, S["n_phen"], replace=False)
    y = rng.normal(0, 1, len(phe_ids))
    t0 = time.perf_counter()
    fit = ht.ssbrm("y ~ 1", data={"id": phe_ids, "y": y}, M=M, M_id=geno_ids,
                   pedigree={"id": ids, "sire": sires, "dam": dams},
                   method="BayesCpi", niter=S["niter"], nburn=S["nburn"],
                   block=S["block"], thin=5, verbose=False, printfreq=0,
                   impute="pcg")
    # the epsilon sweep's tile is min(block, 128) (prepare_gibbs_data)
    eps_kernel = runtime.use_kernels() and BG.supports_mme_block(
        min(S["block"], 128), jnp.float32)
    check(eps_kernel, "the epsilon sweep takes the site scan")
    out = {"path": "ssbrm/pcg/" + draw_path("BayesCpi", S["block"]),
           "eps_path": "kernel", "ids": n_ids, "genotyped": n_g,
           "m": m, "fit_s": round(time.perf_counter() - t0, 1)}
    check(np.isfinite(fit.g["gebv"]).all(), "GEBV not finite")
    check(fit.Veps is not None and np.isfinite(fit.Veps), f"Veps {fit.Veps}")
    out["h2"] = round(float(fit.h2), 4)
    out["Veps"] = round(float(fit.Veps), 4)

    # the epsilon sweep alone on this pedigree's non-genotyped block
    _, s_idx, d_idx = make_ped(ids, sires, dams)
    Ai = sp.csr_matrix(make_ainv(s_idx, d_idx))
    ng = np.setdiff1d(np.arange(n_ids), [np.flatnonzero(ids == g)[0]
                                          for g in geno_ids])
    A = Ai[ng][:, ng]
    perm = rcm_permutation(A)
    A = A[perm][:, perm]
    sp_obj, q_pad = _build_epsl_sparse(A, S["mme_T"], jnp.float32)
    q = A.shape[0]
    counts = np.zeros(q_pad, np.float32)
    counts[:q] = rng.integers(0, 2, q)
    b = np.zeros(q_pad, np.float32)
    b[:q] = rng.normal(size=q)
    z = np.zeros(q_pad, np.float32)
    z[:q] = rng.normal(size=q)
    args = (sp_obj, jnp.asarray(counts), jnp.float32(0.7),
            jnp.zeros(q_pad, jnp.float32), jnp.asarray(b), jnp.float32(1.3),
            jnp.asarray(z))
    sweep = jax.jit(blocked_mme_gibbs_sparse, static_argnames="use_pallas")
    (x_k, _), t_k = timed(lambda *a: sweep(*a, use_pallas=True), *args,
                          reps=S["reps"])
    (x_s, _), t_s = timed(lambda *a: sweep(*a, use_pallas=False), *args,
                          reps=max(1, min(S["reps"], 2)))
    err = float(np.abs(np.asarray(x_k) - np.asarray(x_s)).max()
                / (np.abs(np.asarray(x_s)).max() + 1e-30))
    check(err <= 1e-4, f"epsilon sweep err {err}")
    out.update({"qe": q, "eps_err": f"{err:.2g}",
                "eps_kernel_ms_per_iter": round(1e3 * t_k, 2),
                "eps_scan_ms_per_iter": round(1e3 * t_s, 2)})
    return out


@phase("phase6 four cards")
def phase6(S):
    """The front-ends on four cards: ibrm(mesh=) on a (1,4) snp mesh (what
    the CLI's --shards 4 builds), with the pipeline schedule and 4 chains,
    and sbrm(mesh=) on tiled LD.  Then the engine steps these fits run —
    ibrm BayesR on (1,4) snp and (4,1) ind meshes, the pipeline schedule
    and the sbrm tiled sweep — each compared with the same step on one
    card, from the same state, for 3 iterations."""
    import dataclasses

    import jax

    import hibayes_tpu as ht
    from hibayes_tpu import runtime
    from hibayes_tpu.engine import gibbs as G
    from hibayes_tpu.engine import sgibbs as SG
    from hibayes_tpu.parallel.mesh import (
        make_mesh, shard_gibbs_data, shard_sgibbs_data, shard_state)

    check(len(jax.devices()) >= 4, f"needs 4 devices, found {len(jax.devices())}")
    out = {"path": "mesh/" + draw_path("BayesR", S["block"]),
           "devices": ",".join(str(d.id) for d in jax.devices()[:4])}
    n, m = S["n_anchor"], S["m"]
    M, ids, data, g_true = sim_cohort(1, n, m)
    fit_kw = dict(data=data, M=M, M_id=ids, method="BayesR", block=S["block"],
                  thin=5, verbose=False, printfreq=0,
                  mesh=make_mesh(4, shape=(1, 4)))
    for label, kw in (
            ("ibrm_snp_turn", dict(niter=20, nburn=10)),
            ("ibrm_pipeline", dict(niter=30, nburn=10, nchains=4,
                                   shard_schedule="pipeline"))):
        t0 = time.perf_counter()
        fit = ht.ibrm("y ~ x1 + (1|grp)", **fit_kw, **kw)
        out[f"{label}_fit_s"] = round(time.perf_counter() - t0, 1)
        h2, corr = float(fit.h2), gebv_corr(fit, ids, g_true)
        check(np.isfinite(h2) and np.isfinite(corr),
              f"{label}: h2 {h2}, GEBV corr {corr}")
        if S["check_fit"]:
            check(corr > 0.5, f"{label}: GEBV corr {corr}")
        out[f"{label}_h2"] = round(h2, 4)
        out[f"{label}_gebv_corr"] = round(corr, 4)
    del fit
    G, d1, spec, pr, pi = engine_problem(M, data["y"], "BayesR", S["block"])
    key = jax.random.PRNGKey(5)

    def mesh_run(label, spec_m, mesh, s0, one, batch_keys=None):
        dm = shard_gibbs_data(d1, mesh)
        if batch_keys is None:
            ref = bind(lambda d, s: G.one_iteration(one, d, key, s), d1)
            with mesh:
                stp = bind(lambda d, s: G.one_iteration(spec_m, d, key, s,
                                                        mesh=mesh), dm)
            put = lambda s: shard_state(s, mesh)
        else:
            ref = bind(lambda d, s: G.one_iteration_batch(
                one, d, batch_keys, s), d1)
            with mesh:
                stp = bind(lambda d, s: G.one_iteration_batch(
                    spec_m, d, batch_keys, s, mesh=mesh), dm)
            put = lambda s: s
        s = s0
        worst = {}
        with mesh:
            for _ in range(3):
                r = ref(s)
                t = stp(put(s))
                c = compare_step(r, t)
                worst = {k: max(worst.get(k, 0), v) if k != "agree" else
                         min(worst.get(k, 1), v) for k, v in c.items()}
                s = r
            _, t_m = timed(stp, put(s), reps=S["reps"])
        _, t_1 = timed(ref, s, reps=S["reps"])
        placed = {d.id for d in dm.X_blocks.sharding.device_set}
        check(len(placed) == 4, f"{label}: genotype on devices {placed}")
        out.update({f"{label}_{k}": v for k, v in fmt(worst).items()})
        out[f"{label}_ms_per_iter"] = round(1e3 * t_m, 2)
        out[f"{label}_one_card_ms_per_iter"] = round(1e3 * t_1, 2)

    s0 = G.init_state(spec, d1, pr, pi)
    mesh_run("snp_turn", spec, make_mesh(4, shape=(1, 4)), s0, spec)
    mesh_run("ind", spec, make_mesh(4, shape=(4, 1)), s0, spec)
    keys = jax.random.split(key, 4)
    sb = jax.tree_util.tree_map(lambda x: jax.numpy.broadcast_to(
        x, (4,) + x.shape), s0)
    mesh_run("pipeline", dataclasses.replace(spec, shard_schedule="pipeline"),
             make_mesh(4, shape=(1, 4)), sb,
             dataclasses.replace(spec, shard_schedule="pipeline",
                                 emulate_shards=4), batch_keys=keys)
    del d1, M, fit_kw

    # sbrm tiled LD on (1,4): the front-end, then its engine step
    X = banded_genotype(3, S["n_ld"], m)
    ld = ht.ldmat(X, chisq=30.0, tiled=True, tile=S["block"], stripe=4096)
    ss = sumstats(X, 4)
    smesh = make_mesh(4, shape=(1, 4))
    t0 = time.perf_counter()
    sfit = ht.sbrm(ss, ld, method="BayesCpi", niter=20, nburn=10,
                   verbose=False, printfreq=0, mesh=smesh)
    out["sbrm_mesh_fit_s"] = round(time.perf_counter() - t0, 1)
    check(np.isfinite(sfit.h2) and 0 <= sfit.h2 < 1, f"sbrm h2 {sfit.h2}")
    out["sbrm_mesh_h2"] = round(float(sfit.h2), 4)
    sdata, n_eff, vary, nvar0, seg_sizes, seg_real = SG.prepare_sgibbs_data(
        ss, ld, fold=np.zeros(2), block=S["block"])
    spr = G.resolve_priors(None, float(np.sum(np.asarray(ld.diag))), 0.95,
                           nr=0, vary=vary)
    sspec = G.GibbsSpec(
        model="BayesCpi", n=n_eff, m=m, m_pad=int(sum(seg_sizes)),
        block=S["block"], nc=0, nlevels=(), n_fold=2, niter=10, nburn=5,
        thin=1, nvar0=nvar0, dfvara=spr.dfvara, s2vara=spr.s2vara,
        dfvare=spr.dfvare, s2vare=spr.s2vare, s2varg=spr.s2varg,
        lambda_rate0=spr.lambda_rate0, vargl_strict_pos=True,
        real_excl_nvar0=True, vary=vary, seg_sizes=seg_sizes,
        seg_real=seg_real, use_pallas=runtime.use_kernels())
    sd4 = shard_sgibbs_data(sdata, smesh)
    ref = bind(lambda d, s: SG.one_s_iteration(sspec, d, key, s), sdata)
    with smesh:
        stp = bind(lambda d, s: SG.one_s_iteration(sspec, d, key, s,
                                                   mesh=smesh), sd4)
        s = SG.init_s_state(sspec, sdata, spr, np.array([0.95, 0.05]))
        worst = 1.0
        for _ in range(3):
            r, t = ref(s), stp(s)
            worst = min(worst, compare_step(r, t)["agree"])
            s = r
        _, t_m = timed(stp, s, reps=S["reps"])
    _, t_1 = timed(ref, s, reps=S["reps"])
    out.update({"sbrm_tiled_agree": round(worst, 5),
                "sbrm_tiled_ms_per_iter": round(1e3 * t_m, 2),
                "sbrm_tiled_one_card_ms_per_iter": round(1e3 * t_1, 2)})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU mesh phase")
    args = ap.parse_args(argv)
    try:
        import hibayes_tpu  # noqa: F401
        import tests.oracle  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the repository is not importable ({e}); run it "
              "from the root of a checkout", file=sys.stderr)
        return 2
    import jax

    try:
        phase0()
        for fn in ((phase6,) if args.four_cards else
                   (phase1, phase2, phase3, phase4, phase5)):
            fn(FULL)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
