"""`ssbrm`: single-step Bayesian regression with pedigree.

y = Xb + Rr + M a + U eps + e over genotyped AND non-genotyped individuals
(reference: R/ssbayes.r:115-351).  Pipeline: MAF filter, pedigree merge +
ordering, Henderson A-inverse, partitioned sparse solve for the imputation
operator, genotype imputation (device matmul), J covariate, engine run with
the epsilon term, GEBV for every pedigree id.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from .. import runtime
from ..data.pedigree import (
    ImputationOperator,
    make_ainv,
    make_ped,
    rcm_permutation,
    solve_a_ng,
)
from ..engine import gibbs as G
from .formula import build_model_frame
from .ibrm import (
    METHODS,
    _align_data_to_ids,
    _assemble_results,
    _print_header,
    _resolve_windows,
    resolve_iteration_defaults,
)
from .results import BlrMod

HIGHEST = jax.lax.Precision.HIGHEST


def ssbrm(
    formula,
    data=None,
    M=None,
    M_id=None,
    pedigree=None,
    method="BayesCpi",
    map=None,
    Pi=None,
    fold=None,
    niter=None,
    nburn=None,
    thin=5,
    windsize=None,
    windnum=None,
    maf=0.01,
    dfvr=None,
    s2vr=None,
    vg=None,
    dfvg=None,
    s2vg=None,
    ve=None,
    dfve=None,
    s2ve=None,
    printfreq=100,
    seed=666666,
    threads=0,  # host-side codec threads; device compute is XLA-scheduled
    verbose=True,
    block=64,
    dtype=jnp.float32,
    ainv_compat_hibayes=False,
    nchains=1,
    impute="auto",
    chunk_cols=4096,
    mesh=None,
    checkpoint=None,
    progress=False,
) -> BlrMod:
    """impute: "direct" materialises the dense (n_ng, n_g) operator and the
    dense epsilon A-inverse (the reference's R-side path, R/ssbayes.r:296-307
    — fine for small pedigrees); "pcg" is the scale path — matrix-free
    batched-PCG imputation in `chunk_cols` column chunks plus a sparse
    (diag-blocks + per-block COO) A-inverse for the in-chain epsilon Gibbs,
    so no dense (n_ng x n_g) or (qe x qe) matrix ever exists; "auto"
    switches to "pcg" when n_ng * n_g exceeds 2^24 entries.  mesh: shard the
    chain over devices (see engine/gibbs.run_chain)."""
    if method == "BSLMM":
        raise ValueError("BSLMM is not supported for the single-step model.")
    if method not in METHODS:
        raise ValueError(f"unknown method '{method}'")
    if data is None:
        raise ValueError("no data assigned.")
    if M is None:
        raise ValueError("no genotype data.")
    if M_id is None:
        raise ValueError("please assign the individuals id to 'M.id'.")
    if pedigree is None:
        raise ValueError("pedigree should be provided for single-step bayesian model.")

    M_raw = np.asarray(M.values if hasattr(M, "values") else M)
    # f64 working copy below 1 GB; f32 at scale (0/1/2 are exact in f32 and
    # the imputation PCG refines residuals in f64 on host regardless) — but
    # an explicit dtype=f64 request wins: non-integer (imputed-dosage) input
    # must not be silently rounded when the caller asked for f64
    if dtype == jnp.float64:
        _mdt = np.float64
    else:
        _mdt = np.float64 if M_raw.size <= (1 << 27) else np.float32
    M_values = M_raw.astype(_mdt, copy=False)
    M_id = np.asarray(M_id).astype(str)
    if len(M_id) != M_values.shape[0]:
        raise ValueError("number of individuals mismatched in 'M' and 'M.id'.")
    m = M_values.shape[1]

    windindx, windinfo, nw = _resolve_windows(method, map, windsize, windnum, m)
    niter, nburn, Pi, fold = resolve_iteration_defaults(method, niter, nburn, thin, Pi, fold)
    if method in ("BayesRR", "BayesA", "BayesL"):
        Pi = np.array([0.0, 1.0])
        fixpi = True
    else:
        fixpi = method in ("BayesB", "BayesC")

    # --- MAF filter: zero out rare columns (R/ssbayes.r:263-264) ---
    p = M_values.mean(axis=0) / 2.0
    p = np.minimum(p, 1.0 - p)
    if (p < maf).any():
        M_values = M_values.copy()
        M_values[:, p < maf] = 0.0

    # --- pedigree merge: genotyped-but-unpedigreed become founders ---
    ped = np.stack(
        [np.asarray(pedigree[k]).astype(str) for k in list(pedigree)[:3]], axis=1
    ) if isinstance(pedigree, dict) else np.asarray(pedigree).astype(str)
    if ped.shape[1] != 3:
        raise ValueError("3 columns ('id', 'sir', 'dam') are required in pedigree.")
    ped_all_ids = np.unique(ped.astype(str))
    extra = M_id[~np.isin(M_id, ped_all_ids)]
    if len(extra) == len(M_id):
        raise ValueError("no shared individuals between 'M.id' and 'pedigree'.")
    if len(extra):
        ped = np.vstack([ped, np.stack([extra, np.full(len(extra), "0"), np.full(len(extra), "0")], axis=1)])

    # --- phenotype alignment + model frame (on data's own rows) ---
    keys = list(data.keys())
    data_ids = np.asarray(data[keys[0]]).astype(str)
    mf_all = build_model_frame(formula, {k: np.asarray(v) for k, v in data.items()})
    keep0 = mf_all.keep_mask
    y_ids = data_ids[keep0]

    # --- pedigree ordering + A-inverse ---
    ped_ids, s_idx, d_idx = make_ped(ped[:, 0], ped[:, 1], ped[:, 2])
    if np.isin(ped_ids, M_id).all():
        raise ValueError(
            "all individuals have been genotyped, no necessaries to fit single-step bayes model."
        )
    # drop phenotyped ids absent from pedigree/genotype (R/ssbayes.r:277-284)
    in_ped = np.isin(y_ids, ped_ids)
    if (~in_ped).all():
        raise ValueError("no shared individuals between 'data' and 'pedigree'.")
    if (~in_ped).any():
        drop_ids = set(y_ids[~in_ped])
        sel = np.array([i not in drop_ids for i in data_ids])
        keep0 = keep0 & sel
        y_ids = data_ids[keep0]

    Ai = make_ainv(s_idx, d_idx, compat_hibayes=ainv_compat_hibayes)
    g_pos = {v: i for i, v in enumerate(ped_ids)}
    g_indx = np.array([g_pos[i] for i in M_id])
    ng_mask = np.ones(len(ped_ids), dtype=bool)
    ng_mask[g_indx] = False
    ng_indx = np.flatnonzero(ng_mask)
    if impute not in ("auto", "direct", "pcg"):
        raise ValueError("impute must be 'auto', 'direct' or 'pcg'")
    scale_path = impute == "pcg" or (
        impute == "auto" and len(ng_indx) * len(g_indx) > (1 << 24)
    )
    # row-then-column slicing: scipy's np.ix_ on sparse samples the FULL
    # dense index pattern (O(n_ng^2) work) and overflows at 100k-id scale
    Ai_rows = Ai.tocsr()[ng_indx]
    Ai_nn = Ai_rows.tocsc()[:, ng_indx]
    if scale_path:
        # RCM-cluster the non-genotyped block: concentrates A-inverse
        # entries near the diagonal (denser diag blocks, fewer scattered
        # triplets for the in-chain epsilon Gibbs); pure level reordering —
        # results are keyed by id
        perm = rcm_permutation(Ai_nn)
        ng_indx = ng_indx[perm]
        Ai_rows = Ai.tocsr()[ng_indx]
        Ai_nn = Ai_rows.tocsc()[:, ng_indx]
    Mn_id = ped_ids[ng_indx]
    Ai_ng = Ai_rows.tocsc()[:, g_indx]

    if verbose:
        print(f"{len(ped_ids)} pedigree ids; imputing genotype for {len(Mn_id)} "
              f"individuals ({'matrix-free PCG' if scale_path else 'direct solve'})")
    J = np.full(len(M_id), -1.0)
    mn_rows_pheno = None  # filled after y ids are known
    if scale_path:
        a_op = ImputationOperator(Ai_nn, Ai_ng)
        Jn = a_op.apply(J)
        A_ng = None
        Mn = None
    else:
        A_ng = solve_a_ng(Ai_nn, Ai_ng)  # (n_ng, n_g) dense imputation operator
        # genotype imputation on device: Mn = A.ng @ M  (R/ssbayes.r:305-307)
        Mn = np.asarray(
            jnp.matmul(jnp.asarray(A_ng, dtype), jnp.asarray(M_values, dtype), precision=HIGHEST)
        )
        Jn = A_ng @ J

    # --- reorder phenotypes to [genotyped; imputed] (R/ssbayes.r:310-319) ---
    y_all = mf_all.y if (~in_ped).sum() == 0 else None
    # rebuild model frame on the possibly reduced keep mask
    sub_data = {k: np.asarray(v)[keep0] for k, v in data.items()}
    mf = build_model_frame(formula, sub_data)
    assert mf.keep_mask.all()
    y = mf.y
    y_M_id = M_id[np.isin(M_id, y_ids)]
    y_Mn_id = Mn_id[np.isin(Mn_id, y_ids)]
    y_id_comb = np.concatenate([y_M_id, y_Mn_id])
    pos_y = {v: i for i, v in enumerate(y_ids)}
    y_indx = np.array([pos_y[i] for i in y_id_comb])
    y_ord = y[y_indx]
    X_ord = mf.X[y_indx] if mf.X is not None else None
    r_codes_ord = tuple(c[y_indx] for c in mf.R_codes)

    mn_pos = {v: i for i, v in enumerate(Mn_id)}
    y_Mn_indx = np.array([mn_pos[i] for i in y_Mn_id], dtype=np.int64)
    mn_rows_pheno = np.flatnonzero(np.isin(Mn_id, y_ids))
    if scale_path:
        # impute ONLY the phenotyped non-genotyped rows, in column chunks
        Mn_pheno = a_op.impute(
            M_values, rows_needed=mn_rows_pheno, chunk_cols=chunk_cols,
            verbose=verbose,
        )
    else:
        Mn_pheno = Mn[mn_rows_pheno]
    # match the working dtype BEFORE the vstack: an f64 imputed block would
    # promote the whole [M; Mn] stack and double host RSS at scale
    Mn_pheno = np.asarray(Mn_pheno, dtype=M_values.dtype)
    yM = np.vstack([M_values[np.isin(M_id, y_ids)], Mn_pheno])
    yJ = np.concatenate([J[np.isin(M_id, y_ids)], Jn[mn_rows_pheno]])

    ne = len(y_Mn_id)
    qe = len(Mn_id)
    if ne == 0:
        import warnings

        warnings.warn(
            "all phenotypic individuals have genotype information, "
            "thus can't fit imputation errors."
        )

    n = len(y_ord)
    nc = X_ord.shape[1] if X_ord is not None else 0
    nlevels = tuple(int(len(lv)) for lv in mf.R_levels)

    gdata = G.prepare_gibbs_data(
        y_ord, yM, C=X_ord, r_codes=r_codes_ord, r_nlevels=nlevels,
        fold=fold, windindx=windindx, nw=nw,
        epsl_yJ=yJ if ne else None,
        epsl_A=(Ai_nn if scale_path else np.asarray(Ai_nn.todense())) if ne else None,
        epsl_codes=y_Mn_indx if ne else None,
        qe=qe if ne else 0,
        block=block, dtype=dtype,
    )
    vx = np.asarray(gdata.vx)
    nvar0 = int((vx[:m] == 0).sum())
    pr = G.resolve_priors(
        y_ord, float(vx.sum()), float(Pi[0]), nr=len(nlevels),
        vg=vg, dfvg=dfvg, s2vg=s2vg, ve=ve, dfve=dfve, s2ve=s2ve,
        dfvr=dfvr, s2vr=s2vr,
    )
    spec = G.GibbsSpec(
        model=method, n=n,
        m=m, m_pad=int(gdata.xpx.shape[0]),
        block=int(gdata.X_blocks.shape[2]),
        nc=nc, nlevels=nlevels, n_fold=len(Pi), niter=niter, nburn=nburn, thin=thin,
        nvar0=nvar0, nw=nw, fixpi=fixpi,
        dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare,
        dfr=pr.dfr, s2r=pr.s2r, s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0,
        ne=ne if ne else 0, qe=qe if ne else 0,
        qe_pad=int(gdata.epsl_counts.shape[0]) if ne else 0,
        use_pallas=runtime.use_kernels(),
    )
    if verbose:
        _print_header(spec, pr, Pi, fold, method, n, m, nc, nlevels, nw)
        print(f"    Observations with genotype {n - ne}")
        print(f"    Observations with imputed genotype {ne}")
    t0 = time.time()
    rhat = None
    # reference UX: per-printfreq progress rows (Bayes.cpp:884-914) apply to
    # single-step runs too — the longest-running front-end must be resumable
    progress = progress or (verbose and printfreq > 0 and nchains == 1)
    chunk_records = max(int(printfreq) // max(thin, 1), 1) if printfreq else 0
    if nchains > 1:
        state, samples, extras = G.run_chains(
            spec, gdata, pr, Pi, seed=seed, nchains=nchains, mesh=mesh,
            checkpoint_path=checkpoint,
        )
        rhat = extras.get("rhat")
        # flatten (nchains, records, ...) -> (nchains*records, ...)
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
            spec, gdata, pr, Pi, seed=seed, mesh=mesh,
            checkpoint_path=checkpoint, progress=progress,
            chunk_records=chunk_records,
        )
    elapsed = time.time() - t0
    if verbose:
        print(f"MCMC finished: {spec.niter_eff} iterations in {elapsed:.1f}s")

    # assemble: GEBV for ALL pedigree ids = [J;Jn]*J + [M;Mn]@alpha (+eps)
    s = {k: np.asarray(v) for k, v in samples.items()}
    alpha_s = s["alpha"]
    n_rec = alpha_s.shape[0]
    all_ids = np.concatenate([M_id, Mn_id])
    from .ibrm import _big_matmul

    top = _big_matmul(M_values, alpha_s.T)
    # lower block: A.ng @ (M @ alpha') == Mn @ alpha' without materialising Mn
    lower = a_op.apply(top) if scale_path else Mn @ alpha_s.T
    g_samples = np.vstack([top, lower])
    if ne:
        Jcat = np.concatenate([J, Jn])
        g_samples = g_samples + Jcat[:, None] * s["J"][None, :]
        g_samples[len(M_id):] += s["epsilon"].T
    s["g"] = g_samples
    gebv = {"id": all_ids, "gebv": g_samples.mean(axis=1)}

    mu = float(s["mu"].mean())
    beta = s["beta"].mean(axis=0) if nc else None
    r_est = s["r"].mean(axis=0) if nlevels else None

    e = y_ord - mu
    if beta is not None:
        e = e - X_ord @ beta
    if r_est is not None:
        off = 0
        for i, lv in enumerate(mf.R_levels):
            e = e - r_est[off : off + len(lv)][r_codes_ord[i]]
            off += len(lv)
    e = e - yM @ alpha_s.mean(axis=0)
    if ne:
        e = e - float(s["J"].mean()) * yJ
        eps_mean = s["epsilon"].mean(axis=0)
        e[n - ne:] = e[n - ne:] - eps_mean[y_Mn_indx]

    # residuals reported per original phenotype order (R/ssbayes.r:339-341)
    e_full = np.full(len(y_ids), np.nan)
    e_full[y_indx] = e

    r_dict = None
    if r_est is not None:
        levels = np.concatenate([lv for lv in mf.R_levels])
        r_dict = {"Levels": levels, "Estimation": r_est}
    gwas = None
    if windinfo is not None:
        gwas = dict(windinfo)
        gwas["WPPA"] = np.asarray(extras["wppa"])

    res = BlrMod(
        call=f"{formula} + J + M[pedigree]",
        model_desc=f"Single-step Bayesian model fit by [{method}]",
        method=method,
        mu=mu,
        pi=s["pi"].mean(axis=0),
        beta=beta,
        beta_names=mf.X_names,
        r=r_dict,
        r_names=mf.R_names,
        r_nlevels=tuple(len(lv) for lv in mf.R_levels),
        Vr=s["Vr"].mean(axis=0) if nlevels else None,
        Vg=float(s["Vg"].mean()),
        Ve=float(s["Ve"].mean()),
        h2=float(s["h2"].mean()),
        alpha=alpha_s.mean(axis=0),
        g=gebv,
        e={"id": y_ids, "e": e_full},
        pip=np.asarray(extras["pip"]),
        gwas=gwas,
        Veps=float(s["Veps"].mean()) if ne else None,
        J=float(s["J"].mean()) if ne else None,
        epsilon={"id": Mn_id, "epsilon": s["epsilon"].mean(axis=0)} if ne else None,
        MCMCsamples=s,
    )
    res.rhat = rhat
    return res
