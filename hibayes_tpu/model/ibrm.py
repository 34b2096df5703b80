"""`ibrm`: individual-level Bayesian regression (y = Xb + Rr + Ma + e).

High-level orchestration matching the reference front-end semantics
(reference: R/bayes.r:121-320): id intersection + reordering, formula
parsing, NA masking, GWAS windows, iteration/prior defaults, phenotyped /
unphenotyped split, engine dispatch, GEBV and WPPA assembly.
"""

from __future__ import annotations

import time

import jax.numpy as jnp
import numpy as np

from .. import runtime
from ..data.windows import build_windows
from ..engine import gibbs as G
from ..math.grm import make_grm
from .formula import build_model_frame
from .results import BlrMod

METHODS = (
    "BayesCpi", "BayesA", "BayesL", "BSLMM", "BayesR",
    "BayesB", "BayesC", "BayesBpi", "BayesRR",
)
_NO_GWAS = ("BayesA", "BayesRR", "BayesL")


def _align_data_to_ids(data: dict, ids: np.ndarray) -> dict:
    """data[match(M.id, data[,1]), ] — rows reordered to ids, absent -> NA.
    (reference: R/bayes.r:161-165)"""
    keys = list(data.keys())
    id_col = np.asarray(data[keys[0]]).astype(str)
    if len(np.intersect1d(id_col, ids)) == 0:
        raise ValueError("no shared individuals between 'M.id' and the first column in 'data'.")
    pos = {v: i for i, v in enumerate(id_col)}
    idx = np.array([pos.get(i, -1) for i in ids])
    safe = np.clip(idx, 0, None)
    out = {}
    for k in keys:
        col = np.asarray(data[k])
        vals = col[safe]
        if col.dtype.kind in "fc":
            vals = vals.astype(np.float64)
            vals[idx < 0] = np.nan
        else:
            vals = vals.astype(object)
            vals[idx < 0] = "NA"
            vals = np.array([str(v) for v in vals])
        out[k] = vals
    return out


def resolve_iteration_defaults(method, niter, nburn, thin, Pi, fold):
    """Reference defaulting (R/bayes.r:264-279)."""
    if niter is None:
        niter = 50000 if method == "BayesR" else 20000
    if nburn is None:
        nburn = 30000 if method == "BayesR" else 12000
    if thin >= (niter - nburn):
        raise ValueError("bad setting for collecting frequency 'thin'.")
    if Pi is None:
        if method == "BayesR":
            Pi = np.array([0.95, 0.02, 0.02, 0.01])
            if fold is None:
                fold = np.array([0.0, 0.0001, 0.001, 0.01])
        else:
            Pi = np.array([0.95, 0.05])
    else:
        Pi = np.asarray(Pi, dtype=np.float64)
    if method == "BayesR" and fold is None:
        raise ValueError("'fold' should be provided for BayesR model.")
    if len(Pi) < 2:
        raise ValueError("Pi should be a vector.")
    if abs(Pi.sum() - 1.0) > 1e-8:
        raise ValueError("sum of Pi should be 1.")
    if Pi[0] == 1:
        raise ValueError("all markers have no effect size.")
    if ((Pi < 0) | (Pi > 1)).any():
        raise ValueError("elements of Pi should be at the range of [0, 1]")
    return niter, nburn, Pi, (np.asarray(fold, np.float64) if fold is not None else None)


def _resolve_windows(method, map_, windsize, windnum, m):
    if windsize is None and windnum is None:
        return None, None, 0
    if method in _NO_GWAS:
        raise ValueError(f"can not implement GWAS analysis for the method: {method}")
    if map_ is None:
        raise ValueError("map information must be provided.")
    chrom = np.asarray(map_["Chr"] if isinstance(map_, dict) else map_[:, 1])
    pos = np.asarray(map_["Pos"] if isinstance(map_, dict) else map_[:, 2], dtype=np.float64)
    if len(chrom) != m:
        raise ValueError("number of SNPs mismatched between 'map' and 'M'.")
    windindx, windinfo = build_windows(chrom, pos, windsize=windsize, windnum=windnum)
    return windindx, windinfo, int(windindx.max())


def ibrm(
    formula,
    data=None,
    M=None,
    M_id=None,
    method="BayesCpi",
    map=None,
    Pi=None,
    fold=None,
    niter=None,
    nburn=None,
    thin=5,
    windsize=None,
    windnum=None,
    dfvr=None,
    s2vr=None,
    vg=None,
    dfvg=None,
    s2vg=None,
    ve=None,
    dfve=None,
    s2ve=None,
    lambda_=0.0,
    printfreq=100,
    seed=666666,
    threads=0,  # host-side codec threads; device compute is XLA-scheduled
    verbose=True,
    block=64,
    dtype=jnp.float32,
    checkpoint=None,
    progress=False,
    nchains=1,
    mesh=None,
    shard_schedule="turn",
    merge_rounds=1,
    emulate_shards=0,
) -> BlrMod:
    """shard_schedule: how an m-MP (snp-sharded) mesh schedules the sweep —
    "turn" (default) is the exact serialised schedule; "pipeline" keeps all
    S shards busy EXACTLY by ring-rotating chain groups across the shards
    (requires nchains to be a multiple of S; ~S-times the aggregate
    throughput of "turn"); "concurrent" runs all shards simultaneously
    against the round-start residual with `merge_rounds` psum merges per
    iteration (relaxed Hogwild-blocked kernel, ~S-times faster for a SINGLE
    chain, but statistically biased in the rank-deficient m > n regime —
    measured Vg -32% / Ve +52% at n=4096 x m=65536; a warning fires there).
    emulate_shards > 1 runs the chosen schedule with that many VIRTUAL
    shards on a single device (same Markov kernel; for studies/projections).
    """
    if method not in METHODS:
        raise ValueError(f"unknown method '{method}'; choose from {METHODS}")
    if data is None:
        raise ValueError("no data assigned.")
    if M is None:
        raise ValueError("no genotype data.")
    if M_id is None:
        raise ValueError("please assign the individuals id to 'M.id'.")
    M_values = M.values if hasattr(M, "values") else np.asarray(M)
    M_id = np.asarray(M_id).astype(str)
    if len(M_id) != M_values.shape[0]:
        raise ValueError("number of individuals mismatched in 'M' and 'M.id'.")

    aligned = _align_data_to_ids(data, M_id)
    mf = build_model_frame(formula, aligned)
    keep = mf.keep_mask
    y = mf.y
    n = len(y)
    m = M_values.shape[1]

    windindx, windinfo, nw = _resolve_windows(method, map, windsize, windnum, m)
    niter, nburn, Pi, fold = resolve_iteration_defaults(method, niter, nburn, thin, Pi, fold)

    M_phen = M_values[keep]
    Mp = M_values[~keep] if (~keep).any() else None

    # RR/A/L force the mixture off (src/Bayes.cpp:288-291)
    if method in ("BayesRR", "BayesA", "BayesL"):
        Pi = np.array([0.0, 1.0])
        fixpi = True
    else:
        fixpi = method in ("BayesB", "BayesC")

    use_bslmm = method == "BSLMM"
    K = Kval = None
    if use_bslmm:
        Kval, K = make_grm(M_phen, lambda_=lambda_, eigen=True, dtype=dtype)

    nc = mf.X.shape[1] if mf.X is not None else 0
    nlevels = tuple(int(len(lv)) for lv in mf.R_levels)
    n_fold = len(Pi)

    # integer genotypes stay int8 on the device (4x capacity/bandwidth)
    geno_dtype = "int8" if np.issubdtype(np.asarray(M_phen).dtype, np.integer) else None
    # SNP-sharded meshes / the concurrent emulation need the block count
    # divisible by shards (x merge rounds for the concurrent schedule)
    snp_shards = int(mesh.shape.get("snp", 1)) if mesh is not None else 1
    s_eff = snp_shards if snp_shards > 1 else max(int(emulate_shards), 1)
    nbm = s_eff * (int(merge_rounds) if shard_schedule == "concurrent" else 1)
    gdata = G.prepare_gibbs_data(
        y, M_phen, C=mf.X, r_codes=tuple(mf.R_codes), r_nlevels=nlevels,
        fold=fold, windindx=windindx, nw=nw, K=K, Kval=Kval,
        block=block, dtype=dtype, geno_dtype=geno_dtype,
        nblocks_multiple=nbm,
    )
    vx = np.asarray(gdata.vx)
    nvar0 = int((vx[:m] == 0).sum())
    pr = G.resolve_priors(
        y, float(vx.sum()), float(Pi[0]), nr=len(nlevels),
        vg=vg, dfvg=dfvg, s2vg=s2vg, ve=ve, dfve=dfve, s2ve=s2ve,
        dfvr=dfvr, s2vr=s2vr,
    )
    spec = G.GibbsSpec(
        model=method, n=n,
        m=m, m_pad=int(gdata.xpx.shape[0]), block=int(gdata.X_blocks.shape[2]),
        nc=nc, nlevels=nlevels, n_fold=n_fold, niter=niter, nburn=nburn, thin=thin,
        nvar0=nvar0, nw=nw, fixpi=fixpi,
        dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare,
        dfr=pr.dfr, s2r=pr.s2r, s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0,
        use_bslmm=use_bslmm,
        use_pallas=runtime.use_kernels(),
        shard_schedule=shard_schedule, merge_rounds=int(merge_rounds),
        emulate_shards=int(emulate_shards),
    )

    if verbose:
        _print_header(spec, pr, Pi, fold, method, n, m, nc, nlevels, nw)
    t0 = time.time()
    rhat = None
    # reference UX: per-printfreq progress rows (Bayes.cpp:884-914)
    progress = progress or (verbose and printfreq > 0 and nchains == 1)
    chunk_records = max(int(printfreq) // max(thin, 1), 1) if printfreq else 0
    if nchains > 1:
        state, samples, extras = G.run_chains(
            spec, gdata, pr, Pi, seed=seed, nchains=nchains, mesh=mesh,
            checkpoint_path=checkpoint,
        )
        rhat = extras.get("rhat")
        # flatten (nchains, records, ...) -> (nchains*records, ...) for summaries
        samples = {
            # explicit chain*record count: a -1 dim is ambiguous for
            # empty parameters (e.g. beta with no covariates)
            k: np.asarray(v).reshape(
                (np.asarray(v).shape[0] * np.asarray(v).shape[1],)
                + np.asarray(v).shape[2:]
            )
            for k, v in samples.items()
        }
    else:
        state, samples, extras = G.run_chain(
            spec, gdata, pr, Pi, seed=seed, checkpoint_path=checkpoint,
            progress=progress, chunk_records=chunk_records, mesh=mesh,
        )
    elapsed = time.time() - t0
    if verbose:
        print(f"MCMC finished: {spec.niter_eff} iterations in {elapsed:.1f}s "
              f"({spec.niter_eff * m / max(elapsed, 1e-9):.3g} SNP-updates/s)")

    res = _assemble_results(
        method, formula, spec, samples, extras, mf, y, M_id, keep,
        M_phen, Mp, windinfo, K=K, Kval=Kval, sumvx=float(vx.sum()),
        model_desc=f"Individual level Bayesian model fit by [{method}]",
    )
    res.rhat = rhat
    return res


def _print_header(spec, pr, Pi, fold, method, n, m, nc, nlevels, nw):
    name = "Bayes Ridge Regression" if method == "BayesRR" else method
    print("Prior parameters:")
    print(f"    Model fitted at [{name}]")
    print(f"    Number of observations {n}")
    print(f"    Number of covariates {nc + 1}")
    print(f"    Number of envir-random effects {len(nlevels)}")
    print(f"    Number of markers {m}")
    print(f"    Pi {np.round(Pi, 4)}")
    if method == "BayesR":
        print(f"    Group fold {fold}")
    print(f"    Total number of iteration {spec.niter}")
    print(f"    Total number of burn-in {spec.nburn}")
    print(f"    Phenotypic var {pr.vary:.5f}")
    print(f"    Genetic var {pr.vara:.5f}")
    print(f"    Residual var {pr.vare:.5f}")
    print(f"    Marker var {pr.varg:.5f}")
    if nw:
        print(f"    Number of windows for GWAS analysis {nw}")


def _big_matmul(A, B, flop_threshold=2e10, chunk_bytes=1 << 27):
    """A @ B, routed through the device in column chunks when large.

    The GEBV assembly (M @ alpha_samples', R/bayes.r:303-308) is ~26 TFLOP at
    the 500k-SNP flagship config — minutes in host BLAS.  Small products
    stay in NumPy (f64, exact for the golden tests)."""
    A = np.asarray(A)
    B = np.asarray(B)
    if 2.0 * A.shape[0] * A.shape[1] * B.shape[1] < flop_threshold:
        return A @ B
    import jax
    import jax.numpy as jnp

    Ad = jnp.asarray(A, jnp.float32)
    cb = max(1, int(chunk_bytes // (4 * max(A.shape[1], 1))))
    out = np.empty((A.shape[0], B.shape[1]), dtype=np.float64)
    for c0 in range(0, B.shape[1], cb):
        blk = jnp.asarray(B[:, c0 : c0 + cb], jnp.float32)
        out[:, c0 : c0 + cb] = np.asarray(
            jnp.matmul(Ad, blk, precision=jax.lax.Precision.HIGHEST)
        )
    return out


def _assemble_results(
    method, formula, spec, samples, extras, mf, y, M_id, keep,
    M_phen, Mp, windinfo, K=None, Kval=None, sumvx=1.0, model_desc="",
    call_suffix="M",
):
    s = {k: np.asarray(v) for k, v in samples.items()}
    alpha_s = s["alpha"]  # (records, m)

    # BSLMM: map the posterior-mean polygenic effect into SNP space and fold
    # it into every alpha sample (reference src/Bayes.cpp:955-969).  The
    # reference divides by the raw GRM eigenvalues, which explodes on
    # near-null modes; we use the pseudo-inverse (clamp tiny eigenvalues),
    # preserving the mapping on the GRM's column space.
    if method == "BSLMM" and "k_estR" in s:
        k_mean = s["k_estR"].mean(axis=0)
        Kv = np.asarray(Kval, dtype=np.float64)
        cutoff = 1e-6 * Kv.max()
        inv_Kv = np.where(Kv > cutoff, 1.0 / np.maximum(Kv, cutoff), 0.0)
        Kg = (np.asarray(K).T @ k_mean) * inv_Kv / sumvx
        ghat = M_phen.T @ (np.asarray(K) @ Kg)
        ghat = ghat - ghat.mean()
        alpha_s = alpha_s + ghat[None, :]
        s["alpha"] = alpha_s

    alpha = alpha_s.mean(axis=0)
    mu = float(s["mu"].mean())
    pi_mean = s["pi"].mean(axis=0)
    beta = s["beta"].mean(axis=0) if spec.nc else None
    vr = s["Vr"].mean(axis=0) if len(spec.nlevels) else None
    r_est = s["r"].mean(axis=0) if len(spec.nlevels) else None

    # GEBV samples for ALL genotyped ids incl. unphenotyped (R/bayes.r:303-308)
    n_rec = alpha_s.shape[0]
    g_samples = np.zeros((len(M_id), n_rec))
    g_samples[keep] = _big_matmul(M_phen, alpha_s.T)
    if Mp is not None:
        g_samples[~keep] = _big_matmul(Mp, alpha_s.T)
    s["g"] = g_samples
    gebv = {"id": M_id, "gebv": g_samples.mean(axis=1)}

    # residuals from posterior means (src/Bayes.cpp:942-1011)
    e = y - mu
    if beta is not None:
        e = e - mf.X @ beta
    if r_est is not None:
        off = 0
        for i, lv in enumerate(mf.R_levels):
            e = e - r_est[off : off + len(lv)][mf.R_codes[i]]
            off += len(lv)
    e = e - M_phen @ alpha

    r_dict = None
    if r_est is not None:
        levels = np.concatenate([lv for lv in mf.R_levels])
        r_dict = {"Levels": levels, "Estimation": r_est}

    gwas = None
    if windinfo is not None:
        gwas = dict(windinfo)
        gwas["WPPA"] = np.asarray(extras["wppa"])

    res = BlrMod(
        call=f"{formula} + {call_suffix}",
        model_desc=model_desc,
        method=method,
        mu=mu,
        pi=pi_mean,
        beta=beta,
        beta_names=mf.X_names,
        r=r_dict,
        r_names=mf.R_names,
        r_nlevels=tuple(len(lv) for lv in mf.R_levels),
        Vr=vr,
        Vg=float(s["Vg"].mean()),
        Ve=float(s["Ve"].mean()),
        h2=float(s["h2"].mean()),
        alpha=alpha,
        g=gebv,
        e={"id": M_id[keep], "e": e},
        pip=np.asarray(extras["pip"]),
        gwas=gwas,
        Va=float(s["Va"].mean()) if "Va" in s else None,
        Vb=float(s["Vb"].mean()) if "Vb" in s else None,
        MCMCsamples=s,
    )
    return res
