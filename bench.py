"""Benchmark: SNP-updates/sec of the blocked-Gibbs engine on one device.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", "device"};
"device" names the platform, device_kind, device count and (on a GPU) the
card's power limit as nvidia-smi reports it.

vs_baseline compares against an in-process emulation of the reference's
sequential per-SNP loop (one ddot + one daxpy of length n per SNP over BLAS,
the exact hot-loop structure of src/Bayes.cpp:586-605) measured on this
host's CPU — the reference publishes no numbers of its own (BASELINE.md).
"""

import json
import os
import subprocess
import time

import numpy as np


def _sim_geno(rng, n, m, maf=0.3):
    """Fast synthetic int8 genotype: byte LUT instead of np.random.binomial
    (binomial is ~100ns/draw — minutes for large n*m; this is ~1GB/s)."""
    p0 = (1 - maf) ** 2
    p1 = 2 * maf * (1 - maf)
    raw = rng.integers(0, 256, size=(n, m), dtype=np.uint8)
    out = np.ones((n, m), dtype=np.int8)
    out[raw < int(p0 * 256)] = 0
    out[raw >= int((p0 + p1) * 256)] = 2
    return out


def _sim_pheno(rng, M, chunk=8192):
    """y = M @ b + e without materializing a float copy of the genotype."""
    n, m = M.shape
    b = rng.normal(0, 0.05, m).astype(np.float32)
    y = rng.normal(0, 1, n).astype(np.float32)
    for j0 in range(0, m, chunk):
        y += M[:, j0 : j0 + chunk].astype(np.float32) @ b[j0 : j0 + chunk]
    return y


def _pi_fold(model):
    if model == "BayesR":
        return np.array([0.95, 0.02, 0.02, 0.01]), np.array([0.0, 1e-4, 1e-3, 1e-2])
    return np.array([0.95, 0.05]), None


def device_info():
    """Where the numbers were taken: JAX's device, and the card's name and
    power limit (a card below its maximum limit runs slower under load)."""
    import jax

    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    if dev.platform == "gpu":
        info["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
    return info


def measure_engine(n, m, block, niter, model="BayesCpi", dtype=None):
    import jax.numpy as jnp

    from hibayes_tpu import runtime
    from hibayes_tpu.engine import gibbs as G

    dtype = dtype or jnp.float32
    rng = np.random.default_rng(0)
    M = _sim_geno(rng, n, m)
    y = _sim_pheno(rng, M)
    pi, fold = _pi_fold(model)
    data = G.prepare_gibbs_data(y, M, block=block, dtype=dtype, geno_dtype="int8",
                                fold=fold)
    pr = G.resolve_priors(y, float(np.asarray(data.vx).sum()), pi[0], nr=0)

    spec = G.GibbsSpec(
        model=model, n=n, m=m, m_pad=int(data.xpx.shape[0]), block=block,
        nc=0, nlevels=(), n_fold=len(pi), niter=niter, nburn=niter // 2, thin=5,
        nvar0=int((np.asarray(data.vx)[:m] == 0).sum()),
        dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare,
        s2vare=pr.s2vare, s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0,
        use_pallas=runtime.use_kernels(),
    )

    # warmup/compile with the IDENTICAL spec (niter is part of the jit key)
    G.run_chain(spec, data, pr, pi, seed=1)

    t0 = time.time()
    state, samples, extras = G.run_chain(spec, data, pr, pi, seed=2)
    elapsed = time.time() - t0
    iters = spec.niter_eff
    return iters * m / elapsed


def measure_engine_mc(n, m, block, niter, nchains, model="BayesCpi"):
    """Aggregate SNP-updates/s of K chains (the chains share each genotype
    block's products; the draws kernel runs them in tiles of 16)."""
    import jax.numpy as jnp

    from hibayes_tpu import runtime
    from hibayes_tpu.engine import gibbs as G

    rng = np.random.default_rng(0)
    M = _sim_geno(rng, n, m)
    y = _sim_pheno(rng, M)
    pi, fold = _pi_fold(model)
    data = G.prepare_gibbs_data(y, M, block=block, dtype=jnp.float32,
                                geno_dtype="int8", fold=fold)
    pr = G.resolve_priors(y, float(np.asarray(data.vx).sum()), pi[0], nr=0)
    spec = G.GibbsSpec(
        model=model, n=n, m=m, m_pad=int(data.xpx.shape[0]), block=block,
        nc=0, nlevels=(), n_fold=len(pi), niter=niter, nburn=niter // 2, thin=5,
        nvar0=int((np.asarray(data.vx)[:m] == 0).sum()),
        dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare,
        s2vare=pr.s2vare, s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0,
        use_pallas=runtime.use_kernels(),
    )
    G.run_chains(spec, data, pr, pi, nchains=nchains, seed=1)  # compile
    t0 = time.time()
    G.run_chains(spec, data, pr, pi, nchains=nchains, seed=2)
    elapsed = time.time() - t0
    return spec.niter_eff * m * nchains / elapsed, elapsed


def measure_reference_emulation(n, m, iters=10):
    """The reference hot loop: sequential per-SNP ddot + daxpy over a dense
    double genotype (src/Bayes.cpp:586-605), COMPILED C -O3 -march=native
    (native/src/ref_hotloop.c) — an honest stand-in for the Rcpp/BLAS-1 loop.
    Falls back to a NumPy loop (~100x slower) when no toolchain exists."""
    rng = np.random.default_rng(0)
    X = np.asfortranarray(rng.binomial(2, 0.3, size=(n, m)).astype(np.float64))
    yadj = rng.normal(size=n)
    g = np.zeros(m)
    xpx = (X * X).sum(axis=0)
    z = rng.normal(size=(iters, m)).reshape(-1)

    try:
        from hibayes_tpu.native import hotloop

        if hotloop.available():
            hotloop.run(X, yadj.copy(), g.copy(), xpx, z, 1)  # warm cache
            t0 = time.time()
            hotloop.run(X, yadj, g, xpx, z, iters)
            return iters * m / (time.time() - t0)
    except ImportError:
        pass

    ve, varg = 1.0, 0.01
    t0 = time.time()
    for it in range(iters):
        for j in range(m):
            xj = X[:, j]
            rhs = xj @ yadj + xpx[j] * g[j]
            v = xpx[j] + ve / varg
            gi = rhs / v + np.sqrt(ve / v) * z[it * m + j]
            yadj += (g[j] - gi) * xj
            g[j] = gi
    elapsed = time.time() - t0
    return iters * m / elapsed


def main():
    n = int(os.environ.get("BENCH_N", 4096))
    m = int(os.environ.get("BENCH_M", 65536))
    block = int(os.environ.get("BENCH_BLOCK", 128))
    niter = int(os.environ.get("BENCH_ITERS", 200))
    nchains = int(os.environ.get("BENCH_CHAINS", 64))
    model = os.environ.get("BENCH_MODEL", "BayesCpi")

    extra = {}
    if nchains > 1:
        ours, elapsed = measure_engine_mc(n, m, block, niter, nchains, model=model)
        label = f"SNP-updates/s ({model}, n={n}, m={m}, block={block}, chains={nchains})"
        # single-chain vs single-chain alongside the aggregate ratio, so the
        # artifact is self-honest about what the aggregate number compares
        ours_1 = measure_engine(n, m, block, niter, model=model)
        extra["single_chain_value"] = round(ours_1, 1)
    else:
        ours = measure_engine(n, m, block, niter, model=model)
        label = f"SNP-updates/s ({model}, n={n}, m={m}, block={block})"
    base = measure_reference_emulation(min(n, 4096), min(m, 4096))
    if "single_chain_value" in extra:
        extra["single_chain_vs_baseline"] = round(extra["single_chain_value"] / base, 3)
    print(
        json.dumps(
            {
                "metric": label,
                "value": round(ours, 1),
                "unit": "SNP-updates/s",
                "vs_baseline": round(ours / base, 3),
                **extra,
                "device": device_info(),
            }
        )
    )


if __name__ == "__main__":
    main()
