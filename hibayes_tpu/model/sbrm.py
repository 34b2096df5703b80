"""`sbrm`: summary-level Bayesian regression over LD matrices.

High-level orchestration matching the reference front-end
(reference: R/sbayes.r:101-239): LD-type dispatch (dense -> SBayesD
semantics; chi-square-pruned / chromosome-block -> SBayesS semantics with
varediff inflation and the rejection guard), window construction, defaults,
and the non-MCMC conjugate-gradient solver (method="CG", src/cg.cpp).
"""

from __future__ import annotations

import time

import jax.numpy as jnp
import numpy as np

from .. import runtime
from ..data.ld import BlockDiagLD, DenseLD, SparseLD
from ..data.sparse_ld import TiledSparseLD, _tiled_matvec
from ..data.sumstats import sumstat_matrix
from ..engine import gibbs as G
from ..engine import sgibbs as SG
from ..math.solvers import conj_grad
from .ibrm import _resolve_windows, resolve_iteration_defaults
from .results import BlrMod

S_METHODS = (
    "BayesB", "BayesA", "BayesL", "BayesRR", "BayesBpi", "BayesC",
    "BayesCpi", "BayesR", "CG",
)


# above this SNP count a user-supplied scipy-sparse LD auto-routes to the
# O(nnz) tiled layout — SparseLD.from_scipy densifies to (m, m), which is
# exactly the memory blow-up sparse LD exists to avoid (the reference keeps
# arma::sp_mat end-to-end, src/SBayesS.cpp:21, src/tXXmat.cpp:147-152)
_SPARSE_DENSIFY_LIMIT = 20_000


def _coerce_ld(ldm):
    if isinstance(ldm, (DenseLD, SparseLD, BlockDiagLD, TiledSparseLD)):
        return ldm
    try:
        import scipy.sparse as sp

        if sp.issparse(ldm):
            if ldm.shape[0] > _SPARSE_DENSIFY_LIMIT:
                # O(nnz) host/device memory at any m; tile=128 so the
                # sweep's draws kernel runs it (a power-of-two block)
                return TiledSparseLD.from_scipy(ldm, tile=128)
            return SparseLD.from_scipy(ldm)
    except ImportError:
        pass
    arr = np.asarray(ldm)
    if arr.ndim == 2 and arr.shape[0] == arr.shape[1]:
        return DenseLD(values=arr.astype(np.float64))
    raise TypeError("Unrecognized type of ldm.")


def sbrm(
    sumstat,
    ldm,
    method="BayesCpi",
    map=None,
    Pi=None,
    lambda_=None,
    fold=None,
    niter=None,
    nburn=None,
    thin=5,
    windsize=None,
    windnum=None,
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
    nchains=1,
    checkpoint=None,
    progress=False,
    mesh=None,
    shard_schedule="turn",
    merge_rounds=1,
) -> BlrMod:
    """shard_schedule: m-MP sweep schedule under a mesh — "turn" (exact,
    serialised shards) or "concurrent" (all shards sweep against the
    round-start r_hat, `merge_rounds` psum merges per iteration; relaxed
    kernel, ~S-times faster — see engine/gibbs.GibbsSpec)."""
    if method not in S_METHODS:
        raise ValueError(f"unknown method '{method}'; choose from {S_METHODS}")
    ld = _coerce_ld(ldm)
    ss = sumstat_matrix(sumstat)
    m = ss.shape[0]
    if ld.m != m:
        raise ValueError("Number of SNPs not equals.")
    sparse_semantics = isinstance(ld, (SparseLD, BlockDiagLD, TiledSparseLD))
    if isinstance(ld, TiledSparseLD):
        block = ld.tile  # the sweep block IS the LD tile

    windindx, windinfo, nw = _resolve_windows(method, map, windsize, windnum, m)

    if method == "CG":
        return _fit_cg(ss, ld, lambda_, verbose)

    niter, nburn, Pi, fold = resolve_iteration_defaults(method, niter, nburn, thin, Pi, fold)
    if method in ("BayesRR", "BayesA", "BayesL"):
        Pi = np.array([0.0, 1.0])
        fixpi = True
    else:
        fixpi = method in ("BayesB", "BayesC")

    data, n_eff, vary, nvar0, seg_sizes, seg_real = SG.prepare_sgibbs_data(
        ss, ld, fold=fold, windindx=windindx, nw=nw, block=block, dtype=dtype,
    )
    sumvx = float(np.sum(np.asarray(ld.diag)))
    # summary-level prior defaulting (src/SBayesD.cpp:116-152): note
    # vare = vary*(1-h2) — same as individual-level with nr=0
    pr = G.resolve_priors(
        None, sumvx, float(Pi[0]), nr=0,
        vg=vg, dfvg=dfvg, s2vg=s2vg, ve=ve, dfve=dfve, s2ve=s2ve, vary=vary,
    )
    spec = G.GibbsSpec(
        model=method, n=n_eff, m=m, m_pad=int(sum(seg_sizes)), block=block,
        nc=0, nlevels=(), n_fold=len(Pi), niter=niter, nburn=nburn, thin=thin,
        nvar0=nvar0, nw=nw, fixpi=fixpi,
        dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare,
        s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0,
        vargl_strict_pos=True, real_excl_nvar0=True,
        reject_guard=sparse_semantics, vary=vary,
        seg_sizes=seg_sizes, seg_real=seg_real,
        use_pallas=runtime.use_kernels(),
        shard_schedule=shard_schedule, merge_rounds=int(merge_rounds),
    )
    if verbose:
        kind = "sparse/block" if sparse_semantics else "dense"
        print(f"Prior parameters:\n    Model fitted at [{method}] ({kind} LD)")
        print(f"    Population size {n_eff}\n    Number of markers {m}")
        print(f"    Markers used for analysis {m - nvar0}")
        print(f"    Phenotypic var {vary:.5f}")
        print(f"    Total iterations {niter}, burn-in {nburn}")
    t0 = time.time()
    rhat = None
    if nchains > 1:
        if mesh is not None:
            raise ValueError(
                "sbrm(nchains>1, mesh=...) is not supported: the summary "
                "multi-chain runner executes single-device.  Run one chain "
                "with mesh=, or multiple chains without a mesh."
            )
        state, samples, extras = SG.run_s_chains(
            spec, data, pr, Pi, seed=seed, nchains=nchains,
            checkpoint_path=checkpoint, progress=progress,
        )
        rhat = extras.get("rhat")
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
        state, samples, extras = SG.run_s_chain(
            spec, data, pr, Pi, seed=seed, checkpoint_path=checkpoint,
            progress=progress, mesh=mesh,
        )
    elapsed = time.time() - t0
    if verbose:
        print(f"MCMC finished: {spec.niter_eff} iterations in {elapsed:.1f}s "
              f"({spec.niter_eff * m / max(elapsed, 1e-9):.3g} SNP-updates/s)")

    s = {k: np.asarray(v) for k, v in samples.items()}
    alpha = s["alpha"].mean(axis=0)
    gwas = None
    if windinfo is not None:
        gwas = dict(windinfo)
        gwas["WPPA"] = np.asarray(extras["wppa"])
    res = BlrMod(
        call="b ~ nD⁻¹Vα + e",
        model_desc=f"Summary level Bayesian model fit by [{method}]",
        method=method,
        pi=s["pi"].mean(axis=0),
        Vg=float(s["Vg"].mean()),
        Ve=float(s["Ve"].mean()),
        h2=float(s["h2"].mean()),
        alpha=alpha,
        pip=np.asarray(extras["pip"]),
        gwas=gwas,
        MCMCsamples=s,
    )
    res.rhat = rhat
    return res


def _fit_cg(ss, ld, lambda_, verbose) -> BlrMod:
    """Conjugate-gradient solver (method="CG", src/cg.cpp:4-129)."""
    m = ss.shape[0]
    ncol = ss[:, 3]
    n_eff = int(np.round(np.nanmean(ncol[np.isfinite(ncol)])))
    diag = np.asarray(ld.diag, dtype=np.float64)
    xpx = diag * n_eff
    beta_col = np.nan_to_num(ss[:, 1])
    xy = xpx * beta_col
    est = np.isfinite(ss[:, 2]) & np.isfinite(ss[:, 1])
    yyi = np.where(est, xpx * (ss[:, 1] ** 2 + (ss[:, 3] - 2.0) * ss[:, 2] ** 2), 0.0)
    county = int(est.sum())
    if county == 0:
        raise ValueError("Lack of SE.")
    yy = yyi.sum() / county
    vary = yy / (n_eff - 1)

    lam = None
    if lambda_ is not None:
        lam = np.asarray(lambda_, dtype=np.float64)
        if lam.ndim == 0 or lam.size == 1:
            lam = np.full(m, float(lam))
        elif lam.size != m:
            raise ValueError("length of lambda should be equal to the number of SNPs.")

    if isinstance(ld, BlockDiagLD):
        # block-diagonal system: independent CG solve per chromosome block
        g = np.zeros(m)
        off = 0
        for b_, s_ in zip(ld.blocks, ld.sizes):
            bj = jnp.asarray(b_)
            lam_s = jnp.asarray(lam[off : off + s_]) if lam is not None else None
            x, it, err = conj_grad(
                lambda v, bj=bj: bj @ v, jnp.asarray(xy[off : off + s_] / n_eff), lam=lam_s
            )
            g[off : off + s_] = np.asarray(x)
            off += s_
    elif isinstance(ld, TiledSparseLD):
        # O(nnz) device matvec over stored tiles
        tiles = jnp.asarray(ld.tiles)
        cols = jnp.asarray(ld.col_idx)
        val = jnp.asarray(ld.valid)
        mp = ld.m_pad

        def mv(v):
            vp = jnp.zeros(mp, v.dtype).at[:m].set(v)
            return _tiled_matvec(tiles, cols, val, vp)[:m]

        x, it, err = conj_grad(mv, jnp.asarray(xy / n_eff, tiles.dtype),
                               lam=jnp.asarray(lam, tiles.dtype) if lam is not None else None)
        g = np.asarray(x, dtype=np.float64)
        if verbose:
            print(f"CG finished in {int(it)} iterations, err={float(err):.3g}")
    else:
        LD = jnp.asarray(np.asarray(ld.values))
        x, it, err = conj_grad(lambda v: LD @ v, jnp.asarray(xy / n_eff),
                               lam=jnp.asarray(lam) if lam is not None else None)
        g = np.asarray(x)
        if verbose:
            print(f"CG finished in {int(it)} iterations, err={float(err):.3g}")

    vg = n_eff * float(g @ ld.matvec(g)) / (n_eff - 1)
    ve_out = vary - vg
    if verbose:
        print(f"    Genetic var {vg:.4f}\n    Residual var {ve_out:.4f}")
    return BlrMod(
        call="b ~ nD⁻¹Vα + e",
        model_desc="Summary level Bayesian model fit by [CG]",
        method="CG",
        Vg=vg,
        Ve=ve_out,
        h2=vg / max(vg + ve_out, 1e-30),
        alpha=g,
        MCMCsamples={},
    )
