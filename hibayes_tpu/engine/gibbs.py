"""Individual-level MCMC engine: exact blocked Gibbs for the Bayesian alphabet.

A redesign of the reference's monolithic sampler (reference:
src/Bayes.cpp:477-917).  The reference updates SNP effects one at a time,
each draw reading the residual vector mutated by the previous draw — an
O(n*m) chain of BLAS-1 ops that is strictly sequential in m
(src/Bayes.cpp:586-816).  This formulation is mathematically *identical* but
restructured around matrix products:

    for each block b of B SNPs:
        r0   = X_b^T yadj                  # one (B,n)x(n,) product
        scan j in 0..B-1:                  # B sequential draws on O(B) state
            rhs_j = r_local[j] + xpx_j g_j # == dot(X_j, yadj_current)
            draw g_j' per alphabet member
            r_local += (g_j - g_j') W_b[:, j]   # length-B axpy
        yadj += X_b (g_b - g_b')           # one (n,B)x(B,) product

where W_b = X_b^T X_b is the precomputed block Gram matrix.  The identity
dot(X_k, yadj + d*X_j) = dot(X_k, yadj) + d*W[k, j] makes the blocked update
bit-for-bit equivalent to the sequential one in exact arithmetic (verified
against a NumPy oracle in tests/test_blocked_exact.py).  On the GPU the B
draws run in a Pallas-Triton kernel (`ops/blockgibbs.block_draws`); the
per-SNP scan here is its reference.

Multi-device: shard the *individual* axis of X/yadj/u over the mesh; the two
products contract over n so XLA inserts psums, while the draws run
replicated on O(B) state.  The chain remains exact under sharding.

All randomness is derived from deterministic per-iteration streams
(fold_in(iter_key, STREAM_*)) so a NumPy oracle can replay a chain exactly.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

HIGHEST = jax.lax.Precision.HIGHEST

MODEL_INDEX = {
    "BayesRR": 1,
    "BayesA": 2,
    "BayesB": 3,
    "BayesBpi": 3,
    "BayesC": 4,
    "BayesCpi": 4,
    "BSLMM": 4,
    "BayesL": 5,
    "BayesR": 6,
}

# Deterministic RNG stream ids within one iteration (fold_in(iter_key, id)).
STREAM_MU = 0
STREAM_COV = 1
STREAM_SNP_Z = 2
STREAM_SNP_U = 3
STREAM_SNP_CHI = 4
STREAM_SNP_Z2 = 5
STREAM_VARG = 6
STREAM_PI = 7
STREAM_VE = 8
STREAM_BSLMM_Z = 9
STREAM_BSLMM_CHI = 10
STREAM_EPSL_J = 11
STREAM_EPSL_Z = 12
STREAM_EPSL_CHI = 13
STREAM_LAMBDA = 14
STREAM_FACTOR = 20  # factor i uses 20 + 2*i (normals) and 21 + 2*i (chisq)


def _var(x, axis=None):
    """Sample variance with n-1 denominator (arma::var default)."""
    return jnp.var(x, axis=axis, ddof=1)


@dataclass(frozen=True)
class GibbsSpec:
    """Static configuration of one chain (hashable -> part of the jit key)."""

    model: str
    n: int                  # individuals (rows of y and X)
    m: int                  # number of real SNPs
    m_pad: int              # padded to a multiple of block
    block: int
    nc: int                 # fixed covariates
    nlevels: tuple          # env random factor level counts
    n_fold: int
    niter: int
    nburn: int
    thin: int
    nvar0: int              # monomorphic SNP count (vx == 0 among real SNPs)
    nw: int = 0             # GWAS windows (0 = off)
    fixpi: bool = False
    # priors (resolved to numbers before tracing; reference Bayes.cpp:319-363)
    dfvara: float = 4.0
    s2vara: float = 0.0
    dfvare: float = -2.0
    s2vare: float = 0.0
    dfr: float = -1.0
    s2r: float = 0.0
    # chain-start constant s2varg_ = s2vara_/((1-Pi0)*sumvx) (Bayes.cpp:350)
    s2varg: float = 0.0
    # BayesL hyper-prior constants (reference Bayes.cpp:360-363):
    # shape0 = 1.1, rate0 = (shape0-1)/lambda2_init
    lambda_shape0: float = 1.1
    lambda_rate0: float = 0.0
    # single step / BSLMM toggles
    ne: int = 0             # phenotyped individuals with imputed genotype
    qe: int = 0             # epsilon levels (non-genotyped pedigree ids)
    qe_pad: int = 0         # qe padded to the epsilon tile grid (0 -> == qe)
    use_bslmm: bool = False
    # sbrm-style strict positivity check for the BayesL local variance
    vargl_strict_pos: bool = False
    # counting convention of `data.real`: the summary engine's real mask
    # already excludes the nvar0 non-estimable SNPs (sgibbs real = est),
    # the individual engine's does not (real = non-padding, monomorphic
    # included) — mixture counts must not subtract nvar0 twice
    real_excl_nvar0: bool = False
    # SBayesS-style effect rejection guard (needs vary)
    reject_guard: bool = False
    vary: float = 1.0
    # per-block draws in the Pallas kernels (set from hibayes_tpu.runtime:
    # on for the GPU); configurations the kernel does not cover (f64, a
    # block that is not a power of two >= 16) take the XLA scan
    use_pallas: bool = False
    # summary-level engine: per-chromosome LD segment sizes (padded and real)
    seg_sizes: tuple = ()
    seg_real: tuple = ()
    resync_every: int = 256  # periodic f32 drift resync of yadj/u
    # SNP-shard sweep schedule under an m-MP mesh (SURVEY §7 hard-part-1;
    # the reference's hot loop is strictly sequential, src/Bayes.cpp:586-816):
    #   "turn"       — exact: shards sweep one at a time, preserving the
    #                  single-device block order (S-way capacity, ~1x speed)
    #   "concurrent" — relaxed: ALL shards sweep their local blocks
    #                  simultaneously against the residual frozen at round
    #                  start, merged with one psum per round (S-way speedup;
    #                  a Hogwild-blocked kernel — within-shard draws stay
    #                  exactly sequential, cross-shard draws of one round
    #                  don't condition on each other).  CAUTION: this is a
    #                  block-Jacobi splitting of the Gibbs scan; in the
    #                  rank-deficient m > n regime its iteration operator can
    #                  have spectral radius > 1 — measured at n=4096 x
    #                  m=65536 (S=8): Ve inflated ~50%, Vg deflated ~30%,
    #                  GEBV corr 0.947 vs the exact chain, and more merge
    #                  rounds make it WORSE (each round re-applies the
    #                  divergent operator; S=4 x Rm=4 NaNs at demo scale).
    #                  Validated-safe only for m <~ n; prefer "pipeline".
    #   "pipeline"   — EXACT with all shards busy: chains are grouped by
    #                  home shard and ring-rotate across the S SNP shards
    #                  (ppermute) — at every turn each shard sweeps its own
    #                  resident chains over its local blocks, so each chain
    #                  executes a fixed rotated-canonical block order (a
    #                  valid systematic Gibbs scan; chain group c sweeps
    #                  shards c, c+1, ..., c+S-1).  Requires nchains to be a
    #                  multiple of S; group 0's chains are bit-identical to
    #                  the single-device canonical-order chains.
    shard_schedule: str = "turn"
    merge_rounds: int = 1    # concurrent: residual merges per iteration
    # emulate the concurrent/pipeline schedule with S virtual shards on ONE
    # device (identical Markov kernel to the distributed run) — drives
    # single-device accuracy studies
    emulate_shards: int = 0

    def __post_init__(self):
        if self.shard_schedule not in ("turn", "concurrent", "pipeline"):
            raise ValueError(
                f"shard_schedule must be 'turn', 'concurrent' or 'pipeline', "
                f"got {self.shard_schedule!r}"
            )
        if self.merge_rounds < 1:
            raise ValueError("merge_rounds must be >= 1")
        # individual-level engine only (seg_sizes marks a summary-LD spec,
        # where cross-shard coupling is bounded by the LD tile overlap, not
        # by the X'X rank deficiency)
        if (self.shard_schedule == "concurrent" and self.m > self.n
                and not self.seg_sizes):
            import warnings

            warnings.warn(
                f"shard_schedule='concurrent' with m ({self.m}) > n "
                f"({self.n}): the relaxed kernel is a block-Jacobi "
                "splitting whose iteration operator can exceed spectral "
                "radius 1 in this rank-deficient regime — measured Vg "
                "deflation ~30% / Ve inflation ~50% at n=4096 x m=65536, "
                "and divergence (NaN) at high shard x merge-round counts.  "
                "Use shard_schedule='pipeline' (exact, all shards busy, "
                "nchains a multiple of the shard count) or 'turn' (exact).",
                UserWarning, stacklevel=2,
            )

    @property
    def model_index(self) -> int:
        return MODEL_INDEX[self.model]

    @property
    def nblocks(self) -> int:
        return self.m_pad // self.block

    @property
    def n_records(self) -> int:
        return (self.niter - self.nburn) // self.thin

    @property
    def niter_eff(self) -> int:
        # The reference breaks as soon as n_records samples are collected
        # (src/Bayes.cpp:916), i.e. after nburn + n_records*thin iterations.
        return self.nburn + self.n_records * self.thin


class ChainState(NamedTuple):
    it: jnp.ndarray          # iteration counter
    mu: jnp.ndarray
    beta: jnp.ndarray        # (nc,)
    estR: tuple              # per factor (nlev_i,)
    vrtmp: jnp.ndarray       # (nr,)
    vr: jnp.ndarray          # (nr,)
    yadj: jnp.ndarray        # (n,)
    u: jnp.ndarray           # (n,)
    g: jnp.ndarray           # (m_pad,)
    varg: jnp.ndarray        # scalar (shared marker variance)
    vargL: jnp.ndarray       # (m_pad,) BayesL local variances (size 0 otherwise)
    lambda2: jnp.ndarray     # BayesL
    pi: jnp.ndarray          # (n_fold,)
    vara_fold: jnp.ndarray   # (n_fold,) BayesR
    vara: jnp.ndarray
    vare: jnp.ndarray
    track: jnp.ndarray       # (m_pad,) int32 mixture component of last sweep
    nzrate: jnp.ndarray      # (m_pad,) PIP counters
    wppa: jnp.ndarray        # (nw,) window counters
    # BSLMM
    k_estR: jnp.ndarray      # (n,) polygenic effects in data space (size 0 off)
    vbtmp: jnp.ndarray
    va: jnp.ndarray
    vb: jnp.ndarray
    # single-step epsilon
    J_beta: jnp.ndarray
    epsl_estR: jnp.ndarray   # (qe,)
    vepstmp: jnp.ndarray
    veps: jnp.ndarray


class EpslSparse(NamedTuple):
    """Sparse A-inverse(nn) for the single-step epsilon Gibbs: dense (T, T)
    diagonal blocks feed the in-block site draws; the residual scatter walks
    padded per-block COO triplets of A[FORWARD rows, block] (col indices
    in-block; rows of already-swept blocks are dead — the sweep rebuilds the
    residual from scratch each call); the full COO triple serves the matvec
    (quadratic form / residual init).  All O(nnz) — robust to arbitrary
    pedigree graph structure."""

    diag_blocks: jnp.ndarray   # (nbr, T, T)
    blk_rows: jnp.ndarray      # (nbr, P) int32 global row of each entry
    blk_cols: jnp.ndarray      # (nbr, P) int32 in-block column (0..T-1)
    blk_vals: jnp.ndarray      # (nbr, P) (0 padding)
    coo_rows: jnp.ndarray      # (nnz,) int32
    coo_cols: jnp.ndarray      # (nnz,) int32
    coo_vals: jnp.ndarray      # (nnz,)


class GibbsData(NamedTuple):
    """Device-resident inputs. X_blocks is the genotype in block layout."""

    y: jnp.ndarray             # (n,)
    X_blocks: jnp.ndarray      # (nblocks, n, B)
    W_blocks: jnp.ndarray      # (nblocks, B, B) block Gram matrices
    xpx: jnp.ndarray           # (m_pad,)
    vx: jnp.ndarray            # (m_pad,)
    real: jnp.ndarray          # (m_pad,) bool — real (non-padding) SNPs
    C: jnp.ndarray             # (n, nc)
    cpc: jnp.ndarray           # (nc,)
    r_codes: tuple             # per factor (n,) int32
    r_counts: tuple            # per factor (nlev_i,)
    fold: jnp.ndarray          # (n_fold,)
    windindx0: jnp.ndarray     # (m_pad,) int32 0-based window ids (pad -> nw)
    # BSLMM (sizes 0 when off)
    K: jnp.ndarray             # (n, n) eigenvectors of the GRM
    Kval: jnp.ndarray          # (n,)
    # single-step epsilon term (sizes 0 when off)
    epsl_yJ: jnp.ndarray       # (n,) J covariate
    epsl_LHS_A: jnp.ndarray    # (qe, qe) dense A-inverse(nn) block
    epsl_codes: jnp.ndarray    # (ne,) int32 -> level of each imputed individual
    epsl_counts: jnp.ndarray   # (qe_pad,)
    # sparse A-inverse(nn) (replaces dense epsl_LHS_A at scale): dense
    # diagonal blocks for the in-block Gibbs + padded per-block COO triplets
    # for the residual scatter — O(nnz) regardless of the pedigree graph
    # (BSR tiles were tried first and blow up ~10^4x on pedigree patterns:
    # popular sires scatter single entries across hundreds of tiles)
    epsl_sp: tuple = None      # EpslSparse | None


# ---------------------------------------------------------------------------
# per-SNP conditional draws (the "Bayesian alphabet"), one scan step
# ---------------------------------------------------------------------------


def _reject_redraw(spec, consts, gi, mean, sd, vxj, gidx):
    """SBayesS effect rejection guard (src/SBayesS.cpp:388-398, 489-499):
    while gi^2 * vx > vary, redraw (<=100 times, else 0).  The reference also
    clobbers its BayesC variance accumulator inside the retry loop
    (SBayesS.cpp:392) — a bug we deliberately do not replicate; we accumulate
    only the final accepted draw."""
    vary = consts["vary"]
    kr = jax.random.fold_in(consts["reject_key"], gidx)

    def cond(c):
        gi, tries, _ = c
        return (gi * gi * vxj > vary) & (tries <= 100)

    def body(c):
        gi, tries, k = c
        k, sub = jax.random.split(k)
        z = jax.random.normal(sub, dtype=gi.dtype)
        return (mean + sd * z, tries + 1, k)

    gi, _, _ = jax.lax.while_loop(cond, body, (gi, jnp.zeros((), jnp.int32), kr))
    return jnp.where(gi * gi * vxj > vary, 0.0, gi)


def snp_draw(spec: GibbsSpec, consts, rhs, xx, vxj, vei, g_old, z, uu, chi, z2,
             vargL_old, gidx=None):
    """One conditional effect draw — scalar math only, shared between the XLA
    scan and the Pallas kernel body.  Mirrors the six switch cases of the
    reference hot loops (src/Bayes.cpp:586-816, src/SBayesD.cpp:253-456,
    src/SBayesS.cpp:277-530).  ``vei`` is the per-SNP residual variance: the
    chain's vare for individual-level/dense-LD, varediff*vara + vare for
    sparse-LD (SBayesS.cpp:285).

    Returns (gi, track, vargL_new, d_vargi, d_vargR).
    """
    mi = spec.model_index
    dt = vei.dtype
    ve = vei
    active = vxj > 0
    guard = spec.reject_guard and mi in (4, 6)

    zero = jnp.zeros((), dt)
    gi = zero
    track = jnp.zeros((), jnp.int32)
    vargL_new = vargL_old
    d_vargi = zero
    d_vargR = zero

    if mi == 1:  # BayesRR (src/Bayes.cpp:587-605)
        varg = consts["varg"]
        v = xx + ve / varg
        gi = rhs / v + jnp.sqrt(ve / v) * z
    elif mi == 2:  # BayesA: per-SNP variance redrawn first (src/Bayes.cpp:607-626)
        varg = (g_old * g_old + consts["s2varg_df"]) / chi
        v = xx + ve / varg
        gi = rhs / v + jnp.sqrt(ve / v) * z
    elif mi in (3, 4):  # BayesB/Bpi (per-SNP varg) or BayesC/Cpi (shared)
        if mi == 3:
            varg = (g_old * g_old + consts["s2varg_df"]) / chi
        else:
            varg = consts["varg"]
        lhs = xx / ve
        logdetV = jnp.log(varg * lhs + 1.0)
        v = xx + ve / varg
        uhat = rhs / v
        s1 = -0.5 * (logdetV - rhs * uhat / ve) + consts["logpi"][1]
        s0 = consts["logpi"][0]
        accept0 = 1.0 / (1.0 + jnp.exp(s1 - s0))  # P(component 0)
        indist = jnp.where(uu < accept0, 0, 1)
        indist = jnp.where(active, indist, 0)
        gi = rhs / v + jnp.sqrt(ve / v) * z
        if guard:
            gi = _reject_redraw(spec, consts, gi, rhs / v, jnp.sqrt(ve / v), vxj, gidx)
        gi = jnp.where(indist == 1, gi, 0.0)
        track = indist.astype(jnp.int32)
        if mi == 4:
            d_vargi = jnp.where(indist == 1, gi * gi, 0.0)
    elif mi == 5:  # BayesL (src/Bayes.cpp:718-742)
        v = xx + 1.0 / vargL_old
        gi = rhs / v + jnp.sqrt(ve / v) * z
        gi = jnp.where(jnp.abs(gi) < 1e-6, jnp.asarray(1e-6, dt), gi)
        lam2 = consts["lambda2"]
        lam = jnp.sqrt(lam2)
        ig = _inv_gaussian_from(z2, uu, jnp.sqrt(ve) * lam / jnp.abs(gi), lam2)
        vargi = 1.0 / ig
        ok = (vargi > 0) if spec.vargl_strict_pos else (vargi >= 0)
        vargL_new = jnp.where(active & ok, vargi, vargL_old)
    else:  # BayesR multi-fold mixture (src/Bayes.cpp:743-815), unrolled over
        # the (static) fold count so only scalar ops remain (Pallas-safe).
        # Fold selection is Gumbel-max: ``uu`` carries n_fold uniforms and
        # argmax_f(s_f + G_f) with G_f = -log(-log(u_f)) draws the exact
        # categorical — no softmax normalisation/cumsum in the chain.
        nf = spec.n_fold
        lhs = xx / ve
        gum = -jnp.log(-jnp.log(jnp.maximum(uu, 1e-12)))
        best = consts["logpi"][0] + gum[0]
        indist = jnp.zeros((), jnp.int32)
        for f in range(1, nf):
            vf = jnp.maximum(consts["vara_fold"][f], 1e-30)
            logdetV = jnp.log(vf * lhs + 1.0)
            uhat = rhs / (xx + ve / vf)
            sf = -0.5 * (logdetV - rhs * uhat / ve) + consts["logpi"][f] + gum[f]
            sel = sf > best
            best = jnp.maximum(sf, best)
            indist = jnp.where(sel, f, indist)
        indist = jnp.where(active, indist, 0)
        # gather vara_fold[indist] / fold[indist] via unrolled selects
        vfold = zero
        ffold = jnp.ones((), dt)
        for f in range(1, nf):
            vfold = jnp.where(indist == f, consts["vara_fold"][f], vfold)
            ffold = jnp.where(indist == f, consts["fold"][f], ffold)
        v = xx + ve / jnp.maximum(vfold, 1e-30)
        gi = rhs / v + jnp.sqrt(ve / v) * z
        if guard:
            gi = _reject_redraw(spec, consts, gi, rhs / v, jnp.sqrt(ve / v), vxj, gidx)
        gi = jnp.where(indist > 0, gi, 0.0)
        track = indist
        d_vargR = jnp.where(indist > 0, gi * gi / jnp.maximum(ffold, 1e-30), 0.0)

    gi = jnp.where(active, gi, 0.0)
    return gi, track, vargL_new, d_vargi, d_vargR


def _snp_scan_step(spec: GibbsSpec, consts, carry, xs):
    """XLA-scan wrapper around `snp_draw`: maintains the block-local dot
    products r_local via the Gram-row axpy."""
    r_local, vargi_acc, vargR_acc = carry
    j, gidx, wrow, xx, vxj, vei, g_old, z, uu, chi, z2, vargL_old = xs
    rhs = r_local[j] + xx * g_old
    gi, track, vargL_new, d_vargi, d_vargR = snp_draw(
        spec, consts, rhs, xx, vxj, vei, g_old, z, uu, chi, z2, vargL_old, gidx
    )
    r_local = r_local + (g_old - gi) * wrow
    return (r_local, vargi_acc + d_vargi, vargR_acc + d_vargR), (gi, track, vargL_new)


def _inv_gaussian_from(z, u, mu, lam):
    y = z * z
    x = mu + 0.5 * mu * mu * y / lam - 0.5 * (mu / lam) * jnp.sqrt(
        4.0 * mu * lam * y + mu * mu * y * y
    )
    return jnp.where(u <= mu / (mu + x), x, mu * mu / x)


def alphabet_global_updates(
    spec: GibbsSpec, key, g, track, real, fold,
    vargi_acc, vargR_acc, vargL, varg, pi, vara_fold, lambda2,
):
    """Post-sweep model-level updates shared by the individual- and
    summary-level engines: marker variance, mixture proportions, BayesL
    lambda (reference: src/Bayes.cpp:603-814 tails of each switch case,
    src/SBayesD.cpp:269-454)."""
    mi = spec.model_index
    dt = g.dtype
    m_real = spec.m
    nvar0 = spec.nvar0
    kvarg = jax.random.fold_in(key, STREAM_VARG)
    kpi = jax.random.fold_in(key, STREAM_PI)
    s2varg_df = jnp.asarray(spec.s2varg * spec.dfvara, dt)

    if mi == 1:
        df = spec.dfvara + m_real - nvar0
        chi = 2.0 * jax.random.gamma(kvarg, jnp.asarray(df / 2.0, dt), dtype=dt)
        varg = (jnp.dot(g, g, precision=HIGHEST) + s2varg_df) / chi
    elif mi == 3:
        nnz = jnp.sum((track == 1) & real).astype(dt)
        fold_num = jnp.stack([m_real - nvar0 - nnz, nnz])
        if not spec.fixpi:
            gam = jax.random.gamma(kpi, fold_num + 1.0, dtype=dt)
            pi = gam / jnp.sum(gam)
    elif mi == 4:
        nnz = jnp.sum((track == 1) & real).astype(dt)
        df = spec.dfvara + nnz
        chi = 2.0 * jax.random.gamma(kvarg, df / 2.0, dtype=dt)
        varg = (vargi_acc + s2varg_df) / chi
        fold_num = jnp.stack([m_real - nvar0 - nnz, nnz])
        if not spec.fixpi:
            gam = jax.random.gamma(kpi, fold_num + 1.0, dtype=dt)
            pi = gam / jnp.sum(gam)
    elif mi == 5:
        shape = spec.lambda_shape0 + m_real - nvar0
        rate = spec.lambda_rate0 + jnp.sum(jnp.where(real, vargL, 0.0)) / 2.0
        lambda2 = jax.random.gamma(
            jax.random.fold_in(key, STREAM_LAMBDA), jnp.asarray(shape, dt), dtype=dt
        ) / rate
    elif mi == 6:
        counts = []
        for f in range(spec.n_fold):
            counts.append(jnp.sum((track == f) & real).astype(dt))
        fold_num = jnp.stack(counts)
        # reference semantics (Bayes.cpp:443-455, SBayesD.cpp:443-455):
        # NnzSnp = m - #(track==0 over ALL m); pi counts subtract nvar0 from
        # the zero fold.  When `real` already excludes the nvar0 SNPs
        # (summary engine), counts[0] IS the reference's fold0 - nvar0.
        zero_all = fold_num[0] + (nvar0 if spec.real_excl_nvar0 else 0)
        nnz = m_real - zero_all
        df = spec.dfvara + nnz
        chi = 2.0 * jax.random.gamma(kvarg, df / 2.0, dtype=dt)
        varg = (vargR_acc + s2varg_df) / chi
        vara_fold = varg * fold
        if not spec.real_excl_nvar0:
            fold_num = fold_num.at[0].add(-nvar0)
        if not spec.fixpi:
            gam = jax.random.gamma(kpi, jnp.maximum(fold_num, 0.0) + 1.0, dtype=dt)
            pi = gam / jnp.sum(gam)
    return varg, pi, vara_fold, lambda2


# ---------------------------------------------------------------------------
# blocked single-site Gibbs for dense MME systems (single-step epsilon term)
# ---------------------------------------------------------------------------


def blocked_mme_gibbs(A, diagA, x, b, ve, z, block):
    """Single-site Gibbs sweep over x | A x = b + noise, blocked.

    Equivalent to the reference's sequential sampler (src/solver.cpp:119-140):
    x_i ~ N((b_i - sum_{k != i} A_ik x_k)/A_ii, ve/A_ii), processed in order.
    Maintains res = b - A x; within a block the correction uses the block
    column slice of A, exactly like the SNP blocked update.
    """
    q = x.shape[0]
    nb = q // block
    res = b - A @ x

    Ablocks = A.reshape(q, nb, block).transpose(1, 0, 2)  # (nb, q, B)

    def block_body(carry, xs):
        x_all, res = carry
        bi, Ab = xs  # Ab: (q, B)
        Wb = jax.lax.dynamic_slice(Ab, (bi * block, 0), (block, block))
        r_local = jax.lax.dynamic_slice(res, (bi * block,), (block,))
        xb = jax.lax.dynamic_slice(x_all, (bi * block,), (block,))
        db = jax.lax.dynamic_slice(diagA, (bi * block,), (block,))
        zb = jax.lax.dynamic_slice(z, (bi * block,), (block,))

        def site(carry_in, sxs):
            r_loc, = carry_in
            j, wcol, xj, aii, zj = sxs
            mean = r_loc[j] / aii + xj
            xnew = mean + jnp.sqrt(ve / aii) * zj
            dx = xnew - xj
            r_loc = r_loc - dx * wcol
            return (r_loc,), (xnew, dx)

        (_,), (xnew_b, dx_b) = jax.lax.scan(
            site,
            (r_local,),
            (jnp.arange(block), Wb.T, xb, db, zb),
        )
        res = res - jnp.matmul(Ab, dx_b, precision=HIGHEST)
        x_all = jax.lax.dynamic_update_slice(x_all, xnew_b, (bi * block,))
        return (x_all, res), None

    (x, _), _ = jax.lax.scan(block_body, (x, res), (jnp.arange(nb), Ablocks))
    return x


def _epsl_matvec(sp: EpslSparse, x, q):
    return jax.ops.segment_sum(
        sp.coo_vals.astype(x.dtype) * x[sp.coo_cols], sp.coo_rows,
        num_segments=q,
    )


def blocked_mme_gibbs_sparse(sp: EpslSparse, counts, scale, x, b, ve, z,
                             use_pallas=False):
    """Single-site Gibbs sweep over LHS = scale*A + diag(counts) with sparse
    A — the counterpart of :func:`blocked_mme_gibbs` for pedigree-sized
    epsilon systems (reference: src/solver.cpp:131-140 iterates arma::sp_mat
    columns).  Per block: the dense diagonal block drives the in-block site
    draws; the residual update scatters this block's O(nnz/block) COO
    triplets.  Storage and work are O(nnz) for ANY sparsity pattern.

    With use_pallas, the T in-block sequential draws run in the Pallas
    kernel (`ops.blockgibbs.mme_block_draws`) instead of a per-site XLA scan
    of T loop trips; the two paths draw identical chains up to f32
    association order.

    Returns (x_new, A @ x_new) — the matvec feeds the veps quadratic form.
    """
    from ..ops import blockgibbs

    q = x.shape[0]
    nbr, T, _ = sp.diag_blocks.shape
    dt = x.dtype
    res = b - scale * _epsl_matvec(sp, x, q) - counts * x
    kernel = use_pallas and blockgibbs.supports_mme_block(T, dt)

    if kernel:
        # per-site constants, vectorized across all blocks up front
        d_all = (scale * jnp.diagonal(sp.diag_blocks, axis1=1, axis2=2)
                 + counts.reshape(nbr, T))
        ok = d_all > 0  # zero-padded tail sites stay frozen
        d_safe = jnp.where(ok, d_all, 1.0)
        invd_all = jnp.where(ok, 1.0 / d_safe, 0.0)
        noise_all = jnp.where(ok, jnp.sqrt(ve / d_safe) * z.reshape(nbr, T),
                              0.0)

    def block_body(carry, xs):
        x_all, res = carry
        i, Wd, rows_i, cols_i, vals_i, cnt_b, zb, invd_b, noise_b = xs
        Wb = scale * Wd.astype(dt) + jnp.diag(cnt_b)
        r_local = jax.lax.dynamic_slice(res, (i * T,), (T,))
        xb = jax.lax.dynamic_slice(x_all, (i * T,), (T,))

        if kernel:
            dx_b = blockgibbs.mme_block_draws(
                Wb, r_local, invd_b, noise_b).astype(dt)
            xnew_b = xb + dx_b
        else:
            db = jnp.diagonal(Wb)

            def site(carry_in, sxs):
                r_loc, = carry_in
                j, wcol, xj, aii, zj = sxs
                ok = aii > 0  # zero-padded tail sites stay frozen
                aii_s = jnp.where(ok, aii, 1.0)
                xnew = jnp.where(
                    ok, r_loc[j] / aii_s + xj + jnp.sqrt(ve / aii_s) * zj, xj)
                dx = xnew - xj
                r_loc = r_loc - dx * wcol
                return (r_loc,), (xnew, dx)

            (_,), (xnew_b, dx_b) = jax.lax.scan(
                site, (r_local,), (jnp.arange(T), Wb.T, xb, db, zb)
            )
        # res -= scale * A[forward rows, block] @ dx: the triplet store is
        # pre-filtered to rows of blocks not yet swept (backward/own rows
        # are never read again — the residual is rebuilt from scratch next
        # call); padding triplets carry val 0 -> harmless adds at row 0
        res = res.at[rows_i].add(-scale * vals_i.astype(dt) * dx_b[cols_i])
        x_all = jax.lax.dynamic_update_slice(x_all, xnew_b, (i * T,))
        return (x_all, res), None

    zeros_bt = jnp.zeros((nbr, T), dt)
    (x, res), _ = jax.lax.scan(
        block_body, (x, res),
        (jnp.arange(nbr), sp.diag_blocks, sp.blk_rows, sp.blk_cols,
         sp.blk_vals, counts.reshape(nbr, T), z.reshape(nbr, T),
         invd_all if kernel else zeros_bt,
         noise_all if kernel else zeros_bt),
    )
    return x, _epsl_matvec(sp, x, q)


# ---------------------------------------------------------------------------
# one full MCMC iteration
# ---------------------------------------------------------------------------


def snp_shard_count(nblocks: int, mesh) -> int:
    """Shards of the SNP-block axis a mesh provides (1 = not sharded)."""
    if mesh is None:
        return 1
    s = int(mesh.shape.get("snp", 1))
    return s if s > 1 and nblocks % s == 0 else 1


def ind_shard_count(mesh) -> int:
    """Shards of the individual axis a mesh provides (1 = not sharded)."""
    if mesh is None:
        return 1
    return int(mesh.shape.get("ind", 1))


def _kernel_draws(spec: GibbsSpec, dt) -> bool:
    """Whether the sweep runs its per-block draws in the Pallas kernel
    (`ops/blockgibbs.block_draws`) rather than the per-SNP XLA scan."""
    from ..ops import blockgibbs

    return spec.use_pallas and blockgibbs.draws_supported(spec, dt)


def _run_sweep_k1(fn, spec, consts, X_blocks, W_blocks, xpx, vx, vei, g, rnd,
                  vargL_in, yadj, u):
    """Run a K-chain sweep as a single chain (add/strip the K=1 axis)."""
    consts_b = jax.tree_util.tree_map(lambda x: jnp.asarray(x)[None], consts)
    out = fn(
        spec, consts_b, X_blocks, W_blocks, xpx, vx,
        vei[None], g[None], *(r[None] for r in rnd),
        vargL_in[None], yadj[None], u[None],
    )
    return tuple(o[0] for o in out)


def one_iteration(spec: GibbsSpec, data: GibbsData, base_key, state: ChainState,
                  mesh=None):
    """One full MCMC iteration = pre-sweep effects + SNP sweep + global
    updates.  Split into three phases so multi-chain execution can vmap the
    cheap phases and hand the sweep to the batched draws kernel."""
    key = jax.random.fold_in(base_key, state.it)
    pre = _pre_sweep(spec, data, key, state)
    args = (spec, pre["consts"], data.X_blocks, data.W_blocks, data.xpx,
            data.vx, pre["vei"], state.g, pre["rnd"], pre["vargL_in"],
            pre["yadj"], pre["u"])

    if snp_shard_count(spec.nblocks, mesh) > 1:
        sweep_out = _sweep_snp_sharded(
            spec, data, pre["consts"], pre["rnd"], pre["vei"], state.g,
            pre["vargL_in"], pre["yadj"], pre["u"], mesh,
        )
    elif (spec.shard_schedule == "concurrent" and spec.emulate_shards > 1
            and ind_shard_count(mesh) <= 1):
        # single-device emulation of the concurrent-shard schedule (same
        # Markov kernel as the S-device distributed run)
        sweep_out = _run_sweep_k1(_sweep_concurrent_emu_mc, *args)
    elif spec.shard_schedule == "pipeline" and spec.emulate_shards > 1:
        raise ValueError(
            "shard_schedule='pipeline' needs a multi-chain batch "
            "(run_chains with nchains a multiple of the shard count); a "
            "single chain has no chain groups to rotate")
    elif _kernel_draws(spec, data.y.dtype):
        # pallas_call has no GSPMD partitioning rule: under an ind-sharded
        # mesh the sweep runs inside shard_map (psum'd r0, replicated draws)
        ind_mesh = mesh if ind_shard_count(mesh) > 1 else None
        sweep_out = _run_sweep_k1(partial(_sweep_kernel_mc, mesh=ind_mesh),
                                  *args)
    else:
        sweep_out = _sweep_xla(
            spec, data, pre["consts"], pre["rnd"], pre["vei"], state.g,
            pre["vargL_in"], pre["yadj"], pre["u"],
        )
    return _post_sweep(spec, data, key, state, pre, sweep_out)


def _pre_sweep(spec: GibbsSpec, data: GibbsData, key, state: ChainState):
    """Intercept, covariates, environmental random effects, BSLMM polygenic
    block, single-step epsilon term; also prepares the sweep constants and
    pre-generated randoms."""
    dt = data.y.dtype
    n = spec.n
    nr = len(spec.nlevels)

    mu, beta, yadj, u, g = state.mu, state.beta, state.yadj, state.u, state.g
    ve = state.vare

    # --- intercept (src/Bayes.cpp:480-482) ---
    z = jax.random.normal(jax.random.fold_in(key, STREAM_MU), dtype=dt)
    delta = jnp.sum(yadj) / n + jnp.sqrt(ve / n) * z
    mu = mu + delta
    yadj = yadj - delta

    # --- fixed covariates, sequential (src/Bayes.cpp:484-494) ---
    if spec.nc:
        z_cov = jax.random.normal(jax.random.fold_in(key, STREAM_COV), (spec.nc,), dtype=dt)

        def cov_body(carry, xs):
            yadj, = carry
            ci, cpci, bi_old, zi = xs
            rhs = jnp.dot(ci, yadj, precision=HIGHEST) + cpci * bi_old
            bi = rhs / cpci + jnp.sqrt(ve / cpci) * zi
            yadj = yadj + (bi_old - bi) * ci
            return (yadj,), bi

        (yadj,), beta = jax.lax.scan(
            cov_body, (yadj,), (data.C.T, data.cpc, beta, z_cov)
        )

    # --- environmental random effects per factor (src/Bayes.cpp:496-516) ---
    estR_new = []
    vrtmp = state.vrtmp
    vr = state.vr
    for i in range(nr):
        nlev = spec.nlevels[i]
        codes = data.r_codes[i]
        counts = data.r_counts[i]
        old = state.estR[i]
        kz = jax.random.fold_in(key, STREAM_FACTOR + 2 * i)
        kchi = jax.random.fold_in(key, STREAM_FACTOR + 2 * i + 1)
        rhs = jax.ops.segment_sum(yadj, codes, num_segments=nlev) + counts * old
        lhs = counts + ve / vrtmp[i]
        zr = jax.random.normal(kz, (nlev,), dtype=dt)
        new = rhs / lhs + jnp.sqrt(ve / lhs) * zr
        yadj = yadj + (old - new)[codes]
        chi = 2.0 * jax.random.gamma(kchi, jnp.asarray((nlev + spec.dfr) / 2.0, dt), dtype=dt)
        vrtmp = vrtmp.at[i].set((jnp.dot(new, new) + spec.s2r * spec.dfr) / chi)
        vr = vr.at[i].set(_var(new))
        estR_new.append(new)
    estR = tuple(estR_new)

    # --- BSLMM polygenic block draw in the GRM eigenbasis (src/Bayes.cpp:518-552) ---
    k_estR, vbtmp, va, vb = state.k_estR, state.vbtmp, state.va, state.vb
    if spec.use_bslmm:
        nk = n
        kz = jax.random.fold_in(key, STREAM_BSLMM_Z)
        kchi = jax.random.fold_in(key, STREAM_BSLMM_CHI)
        k_rhs = yadj + k_estR
        eigval = (data.Kval * ve) / (data.Kval + ve / vbtmp)
        eigval = jnp.maximum(eigval, 0.0)
        proj = jnp.matmul(data.K.T, k_rhs, precision=HIGHEST)
        zk = jax.random.normal(kz, (nk,), dtype=dt)
        k_new = jnp.matmul(
            data.K, (eigval / ve) * proj + jnp.sqrt(eigval) * zk, precision=HIGHEST
        )
        diff = k_estR - k_new
        yadj = yadj + diff
        u = u - diff
        Kg = jnp.matmul(data.K.T, k_new, precision=HIGHEST)
        quad = jnp.dot(Kg, Kg / data.Kval, precision=HIGHEST)
        chi = 2.0 * jax.random.gamma(kchi, jnp.asarray((spec.dfvara + nk) / 2.0, dt), dtype=dt)
        vbtmp = (quad + spec.s2vara * spec.dfvara) / chi
        vb = vbtmp
        k_estR = k_new

    # --- single-step imputation-error term (src/Bayes.cpp:554-584) ---
    J_beta, epsl_estR, vepstmp, veps = (
        state.J_beta, state.epsl_estR, state.vepstmp, state.veps,
    )
    if spec.qe:
        ne, qe = spec.ne, spec.qe
        kj = jax.random.fold_in(key, STREAM_EPSL_J)
        kz = jax.random.fold_in(key, STREAM_EPSL_Z)
        kchi = jax.random.fold_in(key, STREAM_EPSL_CHI)
        JtJ = jnp.dot(data.epsl_yJ, data.epsl_yJ, precision=HIGHEST)
        rhs = jnp.dot(data.epsl_yJ, yadj, precision=HIGHEST) + JtJ * J_beta
        zj = jax.random.normal(kj, dtype=dt)
        J_new = rhs / JtJ + jnp.sqrt(ve / JtJ) * zj
        yadj = yadj + (J_beta - J_new) * data.epsl_yJ
        u = u - (J_beta - J_new) * data.epsl_yJ
        J_beta = J_new
        # epsilon | rest: single-site Gibbs on (Z'Z + Ainn * ve/veps)
        qe_p = spec.qe_pad or qe
        yadj_tail = yadj[n - ne:]
        rhs_e = (
            jax.ops.segment_sum(yadj_tail, data.epsl_codes, num_segments=qe_p)
            + data.epsl_counts * epsl_estR
        )
        scale = ve / vepstmp
        ze = jax.random.normal(kz, (qe_p,), dtype=dt)
        if data.epsl_sp is not None:
            # sparse A-inverse: O(nnz) per sweep, no (qe, qe) dense matrix
            # ever exists on device
            ze = jnp.where(jnp.arange(qe_p) < qe, ze, 0.0)  # freeze pad sites
            new_e, Ae = blocked_mme_gibbs_sparse(
                data.epsl_sp, data.epsl_counts, scale, epsl_estR, rhs_e, ve, ze,
                use_pallas=spec.use_pallas,
            )
            quad = jnp.dot(new_e, Ae, precision=HIGHEST)
        else:
            LHS = data.epsl_LHS_A * scale + jnp.diag(data.epsl_counts)
            diagL = jnp.diag(LHS)
            eb = min(spec.block, qe) if qe % min(spec.block, qe) == 0 else qe
            new_e = blocked_mme_gibbs(LHS, diagL, epsl_estR, rhs_e, ve, ze, eb)
            quad = jnp.dot(
                new_e, jnp.matmul(data.epsl_LHS_A, new_e, precision=HIGHEST)
            )
        diff_e = (epsl_estR - new_e)[data.epsl_codes]
        yadj = yadj.at[n - ne:].add(diff_e)
        u = u.at[n - ne:].add(-diff_e)
        chi = 2.0 * jax.random.gamma(kchi, jnp.asarray((spec.dfvara + qe) / 2.0, dt), dtype=dt)
        vepstmp = (quad + spec.s2vara * spec.dfvara) / chi
        veps = vepstmp
        epsl_estR = new_e

    # --- the per-SNP blocked sweep ---
    # Each stream has its own fold_in key, so skipping an unused stream leaves
    # the consumed streams bit-identical.  chi (gamma rejection sampling) is by
    # far the most expensive draw — only BayesA/B/Bpi (mi 2,3) consume it;
    # u feeds spike/slab, mixture and inverse-Gaussian draws (mi 3,4,5,6);
    # z2 feeds only BayesL's local shrinkage (mi 5).
    m_pad, B = spec.m_pad, spec.block
    mi = spec.model_index
    z_snp = jax.random.normal(jax.random.fold_in(key, STREAM_SNP_Z), (m_pad,), dtype=dt)
    if mi == 6:
        # BayesR Gumbel-max fold selection: n_fold uniforms per SNP
        u_snp = jax.random.uniform(
            jax.random.fold_in(key, STREAM_SNP_U), (m_pad, spec.n_fold), dtype=dt
        )
    elif mi in (3, 4, 5) or spec.reject_guard:
        u_snp = jax.random.uniform(jax.random.fold_in(key, STREAM_SNP_U), (m_pad,), dtype=dt)
    else:
        u_snp = jnp.full((m_pad,), 0.5, dt)
    if mi in (2, 3):
        chi_snp = 2.0 * jax.random.gamma(
            jax.random.fold_in(key, STREAM_SNP_CHI),
            jnp.asarray((spec.dfvara + 1.0) / 2.0, dt),
            (m_pad,),
            dtype=dt,
        )
    else:
        chi_snp = jnp.ones((m_pad,), dt)
    if mi == 5:
        z2_snp = jax.random.normal(jax.random.fold_in(key, STREAM_SNP_Z2), (m_pad,), dtype=dt)
    else:
        z2_snp = jnp.zeros((m_pad,), dt)

    consts = {
        "varg": state.varg,
        "s2varg_df": jnp.asarray(spec.s2varg * spec.dfvara, dt),
        "logpi": jnp.log(state.pi),
        "lambda2": state.lambda2,
        "vara_fold": state.vara_fold,
        "fold": data.fold,
        "vary": jnp.asarray(spec.vary, dt),
        "reject_key": jax.random.fold_in(key, 99),
    }
    vei = jnp.full((m_pad,), ve, dt)
    vargL_in = state.vargL if state.vargL.size else jnp.zeros((m_pad,), dt)

    return {
        "mu": mu, "beta": beta, "estR": estR, "vrtmp": vrtmp, "vr": vr,
        "yadj": yadj, "u": u,
        "k_estR": k_estR, "vbtmp": vbtmp, "va": va, "vb": vb,
        "J_beta": J_beta, "epsl_estR": epsl_estR, "vepstmp": vepstmp,
        "veps": veps,
        "consts": consts, "vei": vei, "vargL_in": vargL_in,
        "rnd": (z_snp, u_snp, chi_snp, z2_snp),
    }


def _sweep_xla(spec: GibbsSpec, data: GibbsData, consts, rnd, vei, g, vargL_in,
               yadj, u):
    """Reference XLA lax.scan sweep (exact; supports every configuration)."""
    dt = yadj.dtype
    m_pad, B = spec.m_pad, spec.block
    z_snp, u_snp, chi_snp, z2_snp = rnd

    def block_body(carry, xs):
        yadj, u, vargi_acc, vargR_acc = carry
        Xb, Wb, xpx_b, vx_b, vei_b, g_old_b, zb, ub, chib, z2b, vargLb, gidx_b = xs
        Xb = Xb.astype(dt)  # int8 storage -> f32 compute
        r0 = jnp.matmul(Xb.T, yadj, precision=HIGHEST)
        (r_fin, vargi_acc, vargR_acc), (g_new_b, track_b, vargL_new_b) = jax.lax.scan(
            partial(_snp_scan_step, spec, consts),
            (r0, vargi_acc, vargR_acc),
            (jnp.arange(B), gidx_b, Wb, xpx_b, vx_b, vei_b, g_old_b, zb, ub, chib, z2b, vargLb),
        )
        dg = g_old_b - g_new_b
        delta = jnp.matmul(Xb, dg, precision=HIGHEST)
        yadj = yadj + delta
        u = u - delta
        return (yadj, u, vargi_acc, vargR_acc), (g_new_b, track_b, vargL_new_b)

    def rs(x):
        # trailing dims (e.g. BayesR's (m_pad, n_fold) uniforms) ride along
        return x.reshape(spec.nblocks, B, *x.shape[1:])

    (yadj, u, vargi_acc, vargR_acc), (g_new, track, vargL_new) = jax.lax.scan(
        block_body,
        (yadj, u, jnp.zeros((), dt), jnp.zeros((), dt)),
        (
            data.X_blocks,
            data.W_blocks,
            rs(data.xpx),
            rs(data.vx),
            rs(vei),
            rs(g),
            rs(z_snp),
            rs(u_snp),
            rs(chi_snp),
            rs(z2_snp),
            rs(vargL_in),
            rs(jnp.arange(m_pad)),
        ),
    )
    return (
        g_new.reshape(m_pad),
        track.reshape(m_pad),
        vargL_new.reshape(m_pad),
        yadj,
        u,
        vargi_acc,
        vargR_acc,
    )


def _sweep_kernel_mc(spec: GibbsSpec, consts_b, X_blocks, W_blocks, xpx, vx,
                     vei_b, g_b, z_b, u_b, chi_b, z2_b, vargL_b, yadj_b,
                     u_vec_b, *, mesh=None):
    """K-chain sweep with the per-block draws in the Pallas kernel: an XLA
    scan over SNP blocks runs r0 = X_b' yadj, the (B, K) draws kernel and
    the residual product (`_sweep_local_blocks`).  Under an ind-sharded
    `mesh` the body runs inside shard_map — pallas_call has no GSPMD
    partitioning rule, so XLA would otherwise gather the full genotype onto
    every device; the r0 contraction is psum'd over `ind` and the draws run
    replicated (bit-identical across replicas).  Reference hot loop:
    src/Bayes.cpp:586-816."""
    nblocks, _, B = X_blocks.shape
    K = yadj_b.shape[0]
    rs = lambda x: x.reshape(nblocks, B)
    rsk = lambda x: x.reshape(K, nblocks, B, *x.shape[2:])
    shared = (rs(xpx), rs(vx), rs(jnp.arange(nblocks * B)))
    chains = tuple(rsk(a) for a in (vei_b, g_b, z_b, u_b, chi_b, z2_b, vargL_b))

    def body(X, W, shared, chains, yadj, u, consts):
        ya2, u2, vi, vR, g_new, track, vargL_new = _sweep_local_blocks(
            spec, consts, X, W, *shared, *chains, yadj, u,
            use_kernel=True, has_ind=mesh is not None)
        return g_new, track, vargL_new, ya2, u2, vi, vR

    args = (X_blocks, W_blocks, shared, chains, yadj_b, u_vec_b, consts_b)
    if mesh is None:
        return body(*args)

    from jax import shard_map
    from jax.sharding import PartitionSpec as PS

    rep = lambda tree: jax.tree_util.tree_map(lambda _: PS(), tree)
    return shard_map(
        body, mesh=mesh,
        in_specs=(PS(None, "ind", None), PS(), rep(shared), rep(chains),
                  PS(None, "ind"), PS(None, "ind"), rep(consts_b)),
        out_specs=(PS(), PS(), PS(), PS(None, "ind"), PS(None, "ind"), PS(),
                   PS()),
        check_vma=False,
    )(*args)


def _sweep_local_blocks(spec: GibbsSpec, consts_b, Xg, Wg, xpx_g, vx_g, gidx_g,
                        vei_g, g_g, z_g, u_g, chi_g, z2_g, vargL_g, yadj, u, *,
                        use_kernel, has_ind):
    """Sweep the given SNP blocks for K chains against (yadj, u) — the
    device-local unit shared by the unsharded sweep, the turn, concurrent
    and pipeline schedules and their single-device emulations.

    Blocked inputs: Xg (nbg, n_loc, B), Wg (nbg, B, B), per-SNP shared
    xpx/vx/gidx (nbg, B), per-chain vei/g/z/u/chi/z2/vargL
    (K, nbg, B[, n_fold]); yadj/u (K, n_loc).  `use_kernel` runs the draws
    in the (B, K) Pallas kernel (r0 psum'd over `ind` when `has_ind`);
    otherwise the per-SNP XLA scan runs vmapped over chains.  Returns
    (ya2, u2, vargi (K,), vargR (K,), g_new (K, nbg*B), track, vargL_new).
    """
    from ..ops import blockgibbs

    dt = yadj.dtype
    nbg, B = Wg.shape[0], Wg.shape[2]
    mg = nbg * B
    K = yadj.shape[0]
    flat = lambda x: x.reshape(-1, *x.shape[2:])
    flatk = lambda x: x.reshape(x.shape[0], -1, *x.shape[3:])
    xpx_l, vx_l = flat(xpx_g), flat(vx_g)
    vei_l, g_l, z_l, u_l, chi_l, z2_l, vargL_l = (
        flatk(a) for a in (vei_g, g_g, z_g, u_g, chi_g, z2_g, vargL_g)
    )

    if use_kernel:
        F = jnp.float32

        def pack_one(consts_k, vei, gg, z, uu, chi, vargL):
            c = dict(consts_k)
            c["vargL_vec"] = vargL
            return blockgibbs._pack_rows(spec, c, xpx_l, vx_l, vei, gg, z, uu, chi)

        P_loc = jax.vmap(pack_one)(consts_b, vei_l, g_l, z_l, u_l, chi_l, vargL_l)
        P_blocks = blockgibbs.to_block_layout(P_loc, nbg, B)

        def block_body(carry, xs):
            ya, uu = carry
            Xb, Wb, P_b = xs
            Xl = Xb.astype(dt)
            r0 = jax.lax.dot_general(
                Xl, ya, (((0,), (1,)), ((), ())),
                preferred_element_type=F, precision=HIGHEST,
            )  # (B, K)
            if has_ind:
                r0 = jax.lax.psum(r0, "ind")
            dg, track_b = blockgibbs.block_draws(spec, P_b, Wb, r0)
            delta = jax.lax.dot_general(
                dg, Xl, (((0,), (1,)), ((), ())),
                preferred_element_type=F, precision=HIGHEST,
            )  # (K, n_loc)
            return (ya + delta, uu - delta), (dg, track_b)

        (ya2, u2), (dgs, tracks) = jax.lax.scan(block_body, (yadj, u),
                                                (Xg, Wg, P_blocks))
        dg = dgs.transpose(2, 0, 1).reshape(K, mg)
        track = tracks.transpose(2, 0, 1).reshape(K, mg)
        g_new = g_l.astype(F) - dg
        out = blockgibbs._phase_c_mc(
            spec, consts_b, vx_l, vei_l, g_new, track.astype(jnp.int32),
            u_l, z2_l, vargL_l, ya2, u2,
        )
        g_new, track, vargL_new, ya2, u2, vargi, vargR = out
        return ya2, u2, vargi, vargR, g_new, track, vargL_new

    # fallback: per-SNP XLA scan vmapped over chains (every configuration)
    def one_chain(consts_k, vei_c, g_c, z_c, u_c, chi_c, z2_c, vargL_c,
                  yadj_c, u_vec_c):
        rb = lambda x: x.reshape(nbg, B, *x.shape[1:])

        def block_body(carry, xs):
            yadj_i, u_i, vargi, vargR = carry
            Xb, Wb, xpxj, vxj, veij, gj, zj, uj, chij, z2j, vLj, gidxj = xs
            Xl = Xb.astype(dt)
            r0 = jnp.matmul(Xl.T, yadj_i, precision=HIGHEST)
            if has_ind:
                r0 = jax.lax.psum(r0, "ind")
            (r_fin, vargi, vargR), (g_new_b, track_b, vargL_new_b) = jax.lax.scan(
                partial(_snp_scan_step, spec, consts_k),
                (r0, vargi, vargR),
                (jnp.arange(B), gidxj, Wb, xpxj, vxj, veij, gj, zj, uj,
                 chij, z2j, vLj),
            )
            dgb = gj - g_new_b
            delta = jnp.matmul(Xl, dgb, precision=HIGHEST)
            return (yadj_i + delta, u_i - delta, vargi, vargR), (
                g_new_b, track_b, vargL_new_b)

        (ya2, u2, vargi, vargR), (gn, tr, vl) = jax.lax.scan(
            block_body,
            (yadj_c, u_vec_c, jnp.zeros((), dt), jnp.zeros((), dt)),
            (Xg, Wg, xpx_g, vx_g, rb(vei_c), rb(g_c), rb(z_c), rb(u_c),
             rb(chi_c), rb(z2_c), rb(vargL_c), gidx_g),
        )
        return (ya2, u2, vargi, vargR, gn.reshape(mg), tr.reshape(mg),
                vl.reshape(mg))

    return jax.vmap(one_chain)(
        consts_b, vei_l, g_l, z_l, u_l, chi_l, z2_l, vargL_l, yadj, u,
    )


def _sweep_concurrent_emu_mc(spec: GibbsSpec, consts_b, X_blocks, W_blocks,
                             xpx, vx, vei_b, g_b, z_b, u_b, chi_b, z2_b,
                             vargL_b, yadj_b, u_vec_b):
    """Single-device emulation of the concurrent-shard schedule with
    S = spec.emulate_shards virtual shards and spec.merge_rounds merge
    rounds — the SAME Markov kernel as the distributed concurrent run
    (each virtual shard's group sweep starts from the round-start residual;
    the deltas are summed, exactly what the psum merge computes), executed
    sequentially on one device.  Used for posterior-agreement studies."""
    dt = yadj_b.dtype
    nb, n, B = X_blocks.shape
    m_pad = nb * B
    K = yadj_b.shape[0]
    S, Rm = spec.emulate_shards, spec.merge_rounds
    if nb % (S * Rm):
        raise ValueError(
            f"emulate_shards*merge_rounds ({S}x{Rm}) must divide the "
            f"{nb} SNP blocks (prepare_gibbs_data(nblocks_multiple=...))"
        )
    nbg = nb // (S * Rm)
    mg = nbg * B
    use_kernel = _kernel_draws(spec, dt)
    gidx = jnp.arange(m_pad)

    # global block index = s*(Rm*nbg) + r*nbg + t: shard-major, contiguous
    # genome runs per shard (matches the mesh's PS("snp") block split);
    # group (s, r) owns the flat SNP slice [(s*Rm + r)*mg, +mg)
    ya, uu = yadj_b, u_vec_b
    vi_t = jnp.zeros((K,), dt)
    vR_t = jnp.zeros((K,), dt)
    groups = [None] * (S * Rm)
    for r in range(Rm):
        dya = jnp.zeros_like(ya)
        du = jnp.zeros_like(uu)
        for s in range(S):
            gi = s * Rm + r
            b0 = gi * nbg
            sl = slice(b0 * B, b0 * B + mg)
            rs = lambda v: v[sl].reshape(nbg, B)
            rsk = lambda v: v[:, sl].reshape(K, nbg, B, *v.shape[2:])
            ya2, u2, vi, vR, gn, tr, vl = _sweep_local_blocks(
                spec, consts_b,
                jax.lax.slice_in_dim(X_blocks, b0, b0 + nbg),
                jax.lax.slice_in_dim(W_blocks, b0, b0 + nbg),
                rs(xpx), rs(vx), rs(gidx), rsk(vei_b), rsk(g_b),
                rsk(z_b), rsk(u_b), rsk(chi_b), rsk(z2_b), rsk(vargL_b),
                ya, uu, use_kernel=use_kernel, has_ind=False,
            )
            dya = dya + (ya2 - ya)
            du = du + (u2 - uu)
            vi_t = vi_t + vi.astype(dt)
            vR_t = vR_t + vR.astype(dt)
            groups[gi] = (gn.astype(dt), tr.astype(jnp.int32), vl.astype(dt))
        ya = ya + dya
        uu = uu + du
    cat = lambda i: jnp.concatenate([g[i] for g in groups], axis=1)
    return cat(0), cat(1), cat(2), ya, uu, vi_t, vR_t


def _sweep_snp_sharded(spec: GibbsSpec, data: GibbsData, consts, rnd, vei, g,
                       vargL_in, yadj, u, mesh):
    """Single-chain SNP-sharded sweep: the K=1 slice of
    :func:`_sweep_snp_sharded_mc` (add/strip the chain axis)."""
    consts_b = jax.tree_util.tree_map(lambda x: jnp.asarray(x)[None], consts)
    out = _sweep_snp_sharded_mc(
        spec, data, consts_b, tuple(r[None] for r in rnd), vei[None], g[None],
        vargL_in[None], yadj[None], u[None], mesh,
    )
    return tuple(o[0] for o in out)


def _sweep_pipeline_emu_mc(spec: GibbsSpec, consts_b, X_blocks, W_blocks,
                           xpx, vx, vei_b, g_b, z_b, u_b, chi_b, z2_b,
                           vargL_b, yadj_b, u_vec_b):
    """Single-device emulation of the ring-pipelined schedule: chain group c
    (batch rows [c*Kg, (c+1)*Kg)) sweeps the S shard block-ranges in rotated
    order c, c+1, ..., c+S-1 with the residual threaded sequentially — per
    chain EXACTLY the distributed pipelined kernel (chains never interact,
    so the time-interleaving of the distributed run is irrelevant).  Group 0
    runs the canonical block order: its chains are bit-identical to the
    plain single-device sweep."""
    dt = yadj_b.dtype
    nb, n, B = X_blocks.shape
    m_pad = nb * B
    K = yadj_b.shape[0]
    S = spec.emulate_shards
    if K % S:
        raise ValueError(
            f"pipeline emulation needs nchains ({K}) to be a multiple of "
            f"emulate_shards ({S})")
    if nb % S:
        raise ValueError(
            f"emulate_shards ({S}) must divide the {nb} SNP blocks "
            f"(prepare_gibbs_data(nblocks_multiple=...))")
    Kg = K // S
    nbg = nb // S
    mg = nbg * B
    use_kernel = _kernel_draws(spec, dt)
    gidx = jnp.arange(m_pad)

    ya_rows, u_rows, vi_rows, vR_rows, g_rows, tr_rows, vl_rows = (
        [], [], [], [], [], [], [])
    for c in range(S):
        rsel = slice(c * Kg, (c + 1) * Kg)
        consts_c = jax.tree_util.tree_map(lambda x: x[rsel], consts_b)
        ya = yadj_b[rsel]
        uu = u_vec_b[rsel]
        vi = jnp.zeros((Kg,), dt)
        vR = jnp.zeros((Kg,), dt)
        pieces = [None] * S
        for t in range(S):
            sblk = (c + t) % S
            b0 = sblk * nbg
            sl = slice(b0 * B, b0 * B + mg)
            rs = lambda v: v[sl].reshape(nbg, B)
            rsk = lambda v: v[rsel][:, sl].reshape(Kg, nbg, B, *v.shape[2:])
            ya, uu, vi_s, vR_s, gn, tr, vl = _sweep_local_blocks(
                spec, consts_c,
                jax.lax.slice_in_dim(X_blocks, b0, b0 + nbg),
                jax.lax.slice_in_dim(W_blocks, b0, b0 + nbg),
                rs(xpx), rs(vx), rs(gidx), rsk(vei_b), rsk(g_b),
                rsk(z_b), rsk(u_b), rsk(chi_b), rsk(z2_b), rsk(vargL_b),
                ya, uu, use_kernel=use_kernel, has_ind=False,
            )
            vi = vi + vi_s.astype(dt)
            vR = vR + vR_s.astype(dt)
            pieces[sblk] = (gn.astype(dt), tr.astype(jnp.int32),
                            vl.astype(dt))
        g_rows.append(jnp.concatenate([p[0] for p in pieces], axis=1))
        tr_rows.append(jnp.concatenate([p[1] for p in pieces], axis=1))
        vl_rows.append(jnp.concatenate([p[2] for p in pieces], axis=1))
        ya_rows.append(ya)
        u_rows.append(uu)
        vi_rows.append(vi)
        vR_rows.append(vR)
    cat0 = lambda xs: jnp.concatenate(xs, axis=0)
    return (cat0(g_rows), cat0(tr_rows), cat0(vl_rows), cat0(ya_rows),
            cat0(u_rows), cat0(vi_rows), cat0(vR_rows))


def _sweep_snp_sharded_mc(spec: GibbsSpec, data: GibbsData, consts_b, rnd_b,
                          vei_b, g_b, vargL_b, yadj_b, u_vec_b, mesh):
    """Exact SNP-axis model-parallel sweep for K chains (SURVEY §2.3 P3/P4;
    reference hot loop: src/Bayes.cpp:586-816 — the reference runs one chain
    on one process; this composes m-MP with multi-chain batching).

    Each device owns a contiguous run of SNP blocks — the X/W block shards
    live only in its memory.  The single-device block ORDER is preserved
    exactly by sweeping shards in turn: shard s runs its local block scan
    for ALL K chains while the others skip (lax.cond), then the (K, n)
    yadj/u deltas are merged into every replica with one psum over the `snp`
    mesh axis.  Same Markov kernel per chain as the single-device sweep; the
    n axis may be sharded simultaneously (psum over `ind` inside the turn).

    The shard-local sweep is `_sweep_local_blocks`: the per-block draws
    kernel inside shard_map (which sees shard-local shapes — no
    partitioning-rule hazard), or the per-SNP XLA scan vmapped over chains
    for configurations the kernel does not cover (f64).
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as PS

    dt = yadj_b.dtype
    B = spec.block
    nb = spec.nblocks
    K = yadj_b.shape[0]
    has_ind = int(mesh.shape.get("ind", 1)) > 1
    S = int(mesh.shape["snp"])
    z_b, u_b, chi_b, z2_b = rnd_b
    # shared per-SNP rows: (m_pad,) -> (nb, B); per-chain rows:
    # (K, m_pad[, nf]) -> (K, nb, B[, nf]) so dim 1 shards over `snp`
    rs = lambda x: x.reshape(nb, B, *x.shape[1:])
    rsk = lambda x: x.reshape(x.shape[0], nb, B, *x.shape[2:])
    pvs = (rs(data.xpx), rs(data.vx), rs(jnp.arange(spec.m_pad)))
    pvk = (rsk(vei_b), rsk(g_b), rsk(z_b), rsk(u_b), rsk(chi_b), rsk(z2_b),
           rsk(vargL_b))

    pipeline = spec.shard_schedule == "pipeline"
    if pipeline:
        if has_ind:
            raise ValueError(
                "shard_schedule='pipeline' does not compose with an "
                "ind-sharded mesh; use a pure m-MP mesh (1, S)"
            )
        if K % S:
            raise ValueError(
                f"shard_schedule='pipeline' needs nchains ({K}) to be a "
                f"multiple of the {S} SNP shards (chains ring-rotate in "
                f"groups of nchains/S)"
            )
    Kg = K // S if pipeline else K
    use_kernel = _kernel_draws(spec, dt)

    def body(X, W, pvst, pvkt, yadj, u, consts):
        xpx_b, vx_b, gidxb = pvst
        nb_loc = X.shape[0]
        m_loc = nb_loc * B
        flatk = lambda x: x.reshape(x.shape[0], -1, *x.shape[3:])
        sweep = partial(
            _sweep_local_blocks, spec, consts,
            use_kernel=use_kernel, has_ind=has_ind,
        )

        if spec.shard_schedule == "concurrent":
            # all shards sweep simultaneously; one residual merge per round
            Rm = spec.merge_rounds
            if nb_loc % Rm:
                raise ValueError(
                    f"merge_rounds ({Rm}) must divide the {nb_loc} local "
                    "SNP blocks (prepare_gibbs_data(nblocks_multiple=...))"
                )
            nbg = nb_loc // Rm
            if Rm == 1:
                # single merge round: sweep the full local blocks directly —
                # no scan, so XLA never copies an X slice per round
                ya2, u2, vi, vR, gn, tr, vl = sweep(
                    X, W, xpx_b, vx_b, gidxb, *pvkt, yadj, u)
                yadj = yadj + jax.lax.psum(ya2 - yadj, "snp")
                u = u + jax.lax.psum(u2 - u, "snp")
                vargi, vargR = vi.astype(dt), vR.astype(dt)
                g_new = gn.astype(dt)
                track = tr.astype(jnp.int32)
                vargL_new = vl.astype(dt)
            else:
                grp = lambda x: x.reshape(Rm, nbg, *x.shape[1:])
                grpk = lambda x: x.reshape(
                    x.shape[0], Rm, nbg, *x.shape[2:]).swapaxes(0, 1)
                xs = (grp(X), grp(W), tuple(grp(a) for a in pvst),
                      tuple(grpk(a) for a in pvkt))

                def round_body(carry, xs_r):
                    ya, uu, vi_t, vR_t = carry
                    Xr, Wr, (xpx_r, vx_r, gidx_r), pvkr = xs_r
                    ya2, u2, vi, vR, gn, tr, vl = sweep(
                        Xr, Wr, xpx_r, vx_r, gidx_r, *pvkr, ya, uu)
                    ya = ya + jax.lax.psum(ya2 - ya, "snp")
                    uu = uu + jax.lax.psum(u2 - uu, "snp")
                    return (ya, uu, vi_t + vi.astype(dt),
                            vR_t + vR.astype(dt)), (
                        gn.astype(dt), tr.astype(jnp.int32), vl.astype(dt))

                (yadj, u, vargi, vargR), (gns, trs, vls) = jax.lax.scan(
                    round_body,
                    (yadj, u, jnp.zeros((K,), dt), jnp.zeros((K,), dt)), xs)
                cat = lambda a: a.swapaxes(0, 1).reshape(K, m_loc)
                g_new, track, vargL_new = cat(gns), cat(trs), cat(vls)
        elif pipeline:
            # ring-pipelined EXACT schedule: chain group c (rows
            # [c*Kg, (c+1)*Kg) of the batch) homes at shard c and visits
            # shards c, c+1, ..., c+S-1 in S turns; every shard sweeps its
            # resident group over its LOCAL blocks each turn, then the
            # travelling state (yadj/u rows + per-chain accumulators) rides
            # one ppermute hop to the next shard.  All S shards compute
            # every turn; each chain runs the exact blocked kernel in a
            # fixed rotated-canonical block order.
            sidx = jax.lax.axis_index("snp")
            g_l = flatk(pvkt[1])
            vargL_l = flatk(pvkt[6])
            perm = [(i, (i + 1) % S) for i in range(S)]
            rows = lambda a, c: jax.lax.dynamic_slice_in_dim(a, c * Kg, Kg, 0)

            # local state arrives as the HOME group's rows (yadj/u in_specs
            # are PS("snp", None) for the pipeline — shard_map slices the
            # batch instead of all-gathering it every iteration)
            ya_loc = yadj
            u_loc = u
            vi_loc = jnp.zeros((Kg,), dt)
            vR_loc = jnp.zeros((Kg,), dt)
            g_cur = g_l.astype(dt)
            tr_cur = jnp.zeros((K, m_loc), jnp.int32)
            vl_cur = vargL_l.astype(dt)
            for t in range(S):
                c = jnp.mod(sidx - t, S).astype(sidx.dtype)  # resident group
                pvk_c = tuple(rows(a, c) for a in pvkt)
                consts_c = jax.tree_util.tree_map(lambda x: rows(x, c),
                                                  consts)
                sweep_c = partial(
                    _sweep_local_blocks, spec, consts_c,
                    use_kernel=use_kernel, has_ind=False,
                )
                ya2, u2, vi, vR, gn, tr, vl = sweep_c(
                    X, W, xpx_b, vx_b, gidxb, *pvk_c, ya_loc, u_loc)
                g_cur = jax.lax.dynamic_update_slice_in_dim(
                    g_cur, gn.astype(dt), c * Kg, 0)
                tr_cur = jax.lax.dynamic_update_slice_in_dim(
                    tr_cur, tr.astype(jnp.int32), c * Kg, 0)
                vl_cur = jax.lax.dynamic_update_slice_in_dim(
                    vl_cur, vl.astype(dt), c * Kg, 0)
                ya_loc, u_loc, vi_loc, vR_loc = (
                    ya2, u2, vi_loc + vi.astype(dt), vR_loc + vR.astype(dt))
                # hop to the next shard (after the last turn this brings
                # every group home)
                ya_loc, u_loc, vi_loc, vR_loc = tuple(
                    jax.lax.ppermute(a, "snp", perm)
                    for a in (ya_loc, u_loc, vi_loc, vR_loc))
            # home rows out: out_specs PS("snp", ...) reassemble the batch
            return (g_cur.reshape(K, nb_loc, B),
                    tr_cur.reshape(K, nb_loc, B),
                    vl_cur.reshape(K, nb_loc, B), ya_loc, u_loc,
                    vi_loc, vR_loc)
        else:
            sidx = jax.lax.axis_index("snp")
            g_l = flatk(pvkt[1])
            vargL_l = flatk(pvkt[6])

            def local_sweep(args):
                ya, uu = args
                return sweep(X, W, xpx_b, vx_b, gidxb, *pvkt, ya, uu)

            def skip(args):
                ya, uu = args
                return (ya, uu, jnp.zeros((K,), dt), jnp.zeros((K,), dt),
                        g_l.astype(dt), jnp.zeros((K, m_loc), jnp.int32),
                        vargL_l.astype(dt))

            def turn(carry, s):
                ya, uu, vargi_t, vargR_t, g_cur, tr_cur, vl_cur = carry
                act = sidx == s
                ya2, u2, vargi, vargR, gn, tr, vl = jax.lax.cond(
                    act, local_sweep, skip, (ya, uu))
                # merge this shard's residual corrections into every replica
                ya = ya + jax.lax.psum(ya2 - ya, "snp")
                uu = uu + jax.lax.psum(u2 - uu, "snp")
                g_cur = jnp.where(act, gn.astype(dt), g_cur)
                tr_cur = jnp.where(act, tr.astype(jnp.int32), tr_cur)
                vl_cur = jnp.where(act, vl.astype(dt), vl_cur)
                return (ya, uu, vargi_t + vargi.astype(dt),
                        vargR_t + vargR.astype(dt), g_cur, tr_cur, vl_cur), None

            init = (yadj, u, jnp.zeros((K,), dt), jnp.zeros((K,), dt),
                    g_l.astype(dt), jnp.zeros((K, m_loc), jnp.int32),
                    vargL_l.astype(dt))
            (yadj, u, vargi, vargR, g_new, track, vargL_new), _ = jax.lax.scan(
                turn, init, jnp.arange(S))
        vargi = jax.lax.psum(vargi, "snp")
        vargR = jax.lax.psum(vargR, "snp")
        return (g_new.reshape(K, nb_loc, B), track.reshape(K, nb_loc, B),
                vargL_new.reshape(K, nb_loc, B), yadj, u, vargi, vargR)

    ind_spec = PS(None, "ind") if has_ind else PS()
    pvs_spec = tuple(PS("snp", *([None] * (x.ndim - 1))) for x in pvs)
    pvk_spec = tuple(PS(None, "snp", *([None] * (x.ndim - 2))) for x in pvk)
    consts_spec = jax.tree_util.tree_map(lambda _: PS(), consts_b)
    if pipeline:
        # home-group rows travel sharded over chains (axis 0) on the way in
        # AND out — shard_map slices the batch instead of all-gathering it
        ya_out, sc_out = PS("snp", None), PS("snp")
    else:
        ya_out, sc_out = ind_spec, PS()
    ya_in = ya_out if pipeline else ind_spec
    out = shard_map(
        body, mesh=mesh,
        in_specs=(PS("snp", "ind" if has_ind else None, None),
                  PS("snp", None, None), pvs_spec, pvk_spec, ya_in,
                  ya_in, consts_spec),
        out_specs=(PS(None, "snp", None), PS(None, "snp", None),
                   PS(None, "snp", None), ya_out, ya_out, sc_out, sc_out),
        check_vma=False,
    )(data.X_blocks, data.W_blocks, pvs, pvk, yadj_b, u_vec_b, consts_b)
    g_new, track, vargL_new, yadj_b, u_vec_b, vargi, vargR = out
    return (g_new.reshape(K, spec.m_pad), track.reshape(K, spec.m_pad),
            vargL_new.reshape(K, spec.m_pad), yadj_b, u_vec_b, vargi, vargR)


def _recompute_residuals(spec: GibbsSpec, data: GibbsData, mu, beta, estR,
                         k_estR, J_beta, epsl_estR, g):
    """Exact recompute of (yadj, u) from the current effect estimates —
    periodic f32 drift correction (the reference carries f64 residuals and
    needs none; we trade one genotype matvec every resync_every iterations)."""
    dt = data.y.dtype
    n = spec.n
    pred = jnp.zeros((n,), dt) + mu
    if spec.nc:
        pred = pred + jnp.matmul(data.C, beta, precision=HIGHEST)
    for i in range(len(spec.nlevels)):
        pred = pred + estR[i][data.r_codes[i]]
    Xg = jnp.einsum(
        "bnk,bk->n", data.X_blocks.astype(dt),
        g.reshape(spec.nblocks, spec.block), precision=HIGHEST,
    )
    u_new = Xg
    pred = pred + Xg
    if spec.use_bslmm:
        pred = pred + k_estR
        u_new = u_new + k_estR
    if spec.qe:
        pred = pred + J_beta * data.epsl_yJ
        u_new = u_new + J_beta * data.epsl_yJ
        tail = epsl_estR[data.epsl_codes]
        pred = pred.at[n - spec.ne:].add(tail)
        u_new = u_new.at[n - spec.ne:].add(tail)
    return data.y - pred, u_new


def _post_sweep(spec: GibbsSpec, data: GibbsData, key, state: ChainState, pre,
                sweep_out, inline_resync: bool = True) -> ChainState:
    """Model-level variance / mixture updates, Vg/Ve draws, PIP/WPPA
    counters, drift resync, state assembly."""
    dt = data.y.dtype
    n = spec.n
    nr = len(spec.nlevels)
    B = spec.block
    g, track, vargL_new, yadj, u, vargi_acc, vargR_acc = sweep_out
    vargL = vargL_new if state.vargL.size else state.vargL
    mu, beta, estR, vrtmp, vr = (
        pre["mu"], pre["beta"], pre["estR"], pre["vrtmp"], pre["vr"],
    )
    k_estR, vbtmp, va, vb = pre["k_estR"], pre["vbtmp"], pre["va"], pre["vb"]
    J_beta, epsl_estR, vepstmp, veps = (
        pre["J_beta"], pre["epsl_estR"], pre["vepstmp"], pre["veps"],
    )

    # --- model-level variance / mixture updates ---
    varg, pi, vara_fold, lambda2 = alphabet_global_updates(
        spec, key, g, track, data.real, data.fold,
        vargi_acc, vargR_acc, vargL,
        state.varg, state.pi, state.vara_fold, state.lambda2,
    )
    if spec.model_index == 4 and spec.use_bslmm:
        va = varg

    # --- genetic + residual variances (src/Bayes.cpp:819-823) ---
    vara = _var(u)
    kve = jax.random.fold_in(key, STREAM_VE)
    chi_e = 2.0 * jax.random.gamma(
        kve, jnp.asarray((spec.n + spec.dfvare) / 2.0, dt), dtype=dt
    )
    vare = (jnp.dot(yadj, yadj, precision=HIGHEST) + spec.s2vare * spec.dfvare) / chi_e

    # --- PIP / WPPA counters post burn-in (src/Bayes.cpp:826-845) ---
    post = state.it >= spec.nburn
    nz = (track > 0) & data.real
    nzrate = state.nzrate + jnp.where(post, nz.astype(dt), 0.0)
    wppa = state.wppa
    if spec.nw:
        win_any = jax.ops.segment_max(
            nz.astype(jnp.int32), data.windindx0, num_segments=spec.nw + 1
        )[: spec.nw]
        wppa = wppa + jnp.where(post, win_any.astype(dt), 0.0)

    # --- periodic drift resync (f32 only; exact recompute of yadj and u) ---
    # inline_resync=False in the multi-chain path: a vmapped lax.cond with a
    # per-chain predicate lowers to select and would run the full-genotype
    # recompute EVERY iteration; one_iteration_batch instead applies
    # _recompute_residuals behind a scalar cond after the vmap.
    if inline_resync and spec.resync_every and dt == jnp.float32:
        def resync(args):
            return _recompute_residuals(
                spec, data, mu, beta, estR, k_estR, J_beta, epsl_estR, g
            )

        yadj, u = jax.lax.cond(
            (state.it % spec.resync_every) == spec.resync_every - 1,
            resync,
            lambda args: args,
            (yadj, u),
        )

    return ChainState(
        it=state.it + 1,
        mu=mu,
        beta=beta,
        estR=estR,
        vrtmp=vrtmp,
        vr=vr,
        yadj=yadj,
        u=u,
        g=g,
        varg=varg,
        vargL=vargL,
        lambda2=lambda2,
        pi=pi,
        vara_fold=vara_fold,
        vara=vara,
        vare=vare,
        track=track,
        nzrate=nzrate,
        wppa=wppa,
        k_estR=k_estR,
        vbtmp=vbtmp,
        va=va,
        vb=vb,
        J_beta=J_beta,
        epsl_estR=epsl_estR,
        vepstmp=vepstmp,
        veps=veps,
    )


# ---------------------------------------------------------------------------
# prior resolution, data preparation, chain driver
# ---------------------------------------------------------------------------


@dataclass
class Priors:
    """Resolved hyperparameters (reference defaulting: src/Bayes.cpp:319-363)."""

    vary: float
    vara: float
    vare: float
    dfvara: float
    s2vara: float
    dfvare: float
    s2vare: float
    varg: float
    s2varg: float
    dfr: float
    s2r: float
    vr_init: float
    lambda2: float
    lambda_rate0: float


def resolve_priors(
    y, sumvx, pi0, nr,
    vg=None, dfvg=None, s2vg=None, ve=None, dfve=None, s2ve=None,
    dfvr=None, s2vr=None, h2=0.5, shape0=1.1, vary=None,
) -> Priors:
    if vary is None:
        y = jnp.asarray(y)
        vary = float(jnp.var(y, ddof=1))
    dfvara = 4.0 if dfvg is None else float(dfvg)
    if dfvara <= 2:
        raise ValueError("dfvg should not be less than 2.")
    vara = ((dfvara - 2.0) / dfvara) * vary * h2 if vg is None else float(vg)
    vare = vary * (1.0 - h2) / (nr + 1.0) if ve is None else float(ve)
    dfvare = -2.0 if dfve is None else float(dfve)
    s2vara = vara * (dfvara - 2.0) / dfvara if s2vg is None else float(s2vg)
    denom = (1.0 - pi0) * float(sumvx)
    varg = vara / denom
    s2varg = s2vara / denom
    s2vare = 0.0 if s2ve is None else float(s2ve)
    dfr = -1.0 if dfvr is None else float(dfvr)
    s2r = 0.0 if s2vr is None else float(s2vr)
    vr_init = vary * (1.0 - h2) / (nr + 1.0)
    R2 = (dfvara - 2.0) / dfvara
    lambda2 = 2.0 * (1.0 - R2) / R2 * float(sumvx)
    lambda_rate0 = (shape0 - 1.0) / lambda2
    return Priors(
        vary=vary, vara=vara, vare=vare, dfvara=dfvara, s2vara=s2vara,
        dfvare=dfvare, s2vare=s2vare, varg=varg, s2varg=s2varg,
        dfr=dfr, s2r=s2r, vr_init=vr_init,
        lambda2=lambda2, lambda_rate0=lambda_rate0,
    )


def pad_to_block(m: int, block: int) -> int:
    return ((m + block - 1) // block) * block


def prepare_gibbs_data(
    y, M, *, C=None, r_codes=(), r_nlevels=(), fold=None, windindx=None, nw=0,
    K=None, Kval=None, epsl_yJ=None, epsl_A=None, epsl_codes=None, qe=0,
    block=64, dtype=jnp.float32, geno_dtype=None, nblocks_multiple=1,
):
    """Build the device-resident GibbsData (block layout, Gram matrices, stats).

    geno_dtype="int8" keeps the genotype device-resident as int8 (4x
    capacity and sweep bandwidth vs f32); the Gram matrices are built with
    exact int32 accumulation (entries <= 4n < 2^24 stay exact in f32) and
    the sweep casts each block to f32.
    """
    y = jnp.asarray(y, dtype)
    n = int(y.shape[0])
    use_int8 = geno_dtype in ("int8", jnp.int8, np.int8)
    M_np = np.asarray(M)
    m = int(M_np.shape[1])
    block = int(min(block, pad_to_block(m, 8)))
    m_pad = pad_to_block(m, block)
    nblocks = m_pad // block
    if nblocks_multiple > 1:
        # SNP-sharded meshes need the block count divisible by the shard
        # count (x merge rounds for the concurrent schedule); extra blocks
        # are all-zero padding (vx == 0 -> inactive, exact no-ops)
        nblocks = -(-nblocks // int(nblocks_multiple)) * int(nblocks_multiple)
        m_pad = nblocks * block

    # epsilon-term A-inverse(nn): dense array (small qe) or scipy sparse —
    # sparse inputs pack into EpslSparse (diag blocks + per-block COO) so the
    # in-chain Gibbs never materialises the (qe, qe) dense matrix
    epsl_sp_obj = None
    qe_pad = qe
    if epsl_A is not None and qe:
        try:
            import scipy.sparse as _sp

            is_sparse = _sp.issparse(epsl_A)
        except ImportError:
            is_sparse = False
        if is_sparse:
            etile = int(min(block, 128))
            epsl_sp_obj, qe_pad = _build_epsl_sparse(epsl_A, etile, dtype)

    if use_int8:
        if not np.issubdtype(M_np.dtype, np.integer):
            if not np.all(M_np == np.round(M_np)):
                raise ValueError("geno_dtype='int8' requires integer genotype codes")
        if m_pad == m and M_np.dtype == np.int8:
            Mi = np.ascontiguousarray(M_np)
        else:
            Mi = np.zeros((n, m_pad), dtype=np.int8)
            Mi[:, :m] = M_np.astype(np.int8)
        X_blocks = jnp.asarray(Mi.reshape(n, nblocks, block).transpose(1, 0, 2))

        # exact integer Gram (int8 x int8 -> int32), cast to f32 (exact
        # below 2^24).
        # Single-argument jit so both dot operands alias ONE device buffer —
        # passing X twice at the primitive level counts the (possibly tens of
        # GB) genotype twice against device memory.
        @jax.jit
        def _block_grams_and_sums(Xb):
            W = jax.lax.dot_general(
                Xb, Xb,
                dimension_numbers=(((1,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.int32,
            )
            s1 = jnp.sum(Xb.astype(jnp.int32), axis=1)  # (nblocks, block)
            return W.astype(dtype), s1

        W_blocks, s1_dev = _block_grams_and_sums(X_blocks)
        # column stats from the exact integer Gram: s2 = diag(W), s1 = col
        # sums — tiny transfers, exact in float64 (all integers < 2^53), no
        # host int64 genotype temporaries (those are O(n*m*8) bytes)
        s2 = np.asarray(
            jnp.diagonal(W_blocks, axis1=1, axis2=2), dtype=np.float64
        ).reshape(m_pad)
        s1 = np.asarray(s1_dev, dtype=np.float64).reshape(m_pad)
        xpx = jnp.asarray(s2, dtype)
        vx = jnp.asarray((s2 - s1 * s1 / n) / (n - 1), dtype)
    else:
        M_j = jnp.asarray(M_np, dtype)
        if m_pad != m:
            M_j = jnp.pad(M_j, ((0, 0), (0, m_pad - m)))
        X_blocks = M_j.reshape(n, nblocks, block).transpose(1, 0, 2)
        W_blocks = jnp.einsum("bnk,bnl->bkl", X_blocks, X_blocks, precision=HIGHEST)
        xpx = jnp.sum(M_j * M_j, axis=0)
        # centered two-pass variance: exact 0 for constant (monomorphic)
        # columns, unlike the E[x^2]-E[x]^2 form which leaves rounding dust
        Mc = M_j - jnp.mean(M_j, axis=0, keepdims=True)
        vx = jnp.sum(Mc * Mc, axis=0) / (n - 1)
    real = jnp.arange(m_pad) < m
    vx = jnp.where(real, vx, 0.0)

    if C is None:
        C = jnp.zeros((n, 0), dtype)
    else:
        C = jnp.asarray(C, dtype)
    cpc = jnp.sum(C * C, axis=0)

    r_codes_t = tuple(jnp.asarray(c, jnp.int32) for c in r_codes)
    r_counts_t = tuple(
        jax.ops.segment_sum(jnp.ones((n,), dtype), c, num_segments=int(nl))
        for c, nl in zip(r_codes_t, r_nlevels)
    )

    if fold is None:
        fold = jnp.zeros((2,), dtype)
    else:
        fold = jnp.asarray(fold, dtype)

    if windindx is None or nw == 0:
        wind0 = jnp.zeros((m_pad,), jnp.int32)
        nw = 0
    else:
        wi = jnp.asarray(windindx, jnp.int32) - 1  # to 0-based
        wind0 = jnp.full((m_pad,), nw, jnp.int32).at[:m].set(wi)

    zero = jnp.zeros((0,), dtype)
    return GibbsData(
        y=y,
        X_blocks=X_blocks,
        W_blocks=W_blocks,
        xpx=xpx,
        vx=vx,
        real=real,
        C=C,
        cpc=cpc,
        r_codes=r_codes_t,
        r_counts=r_counts_t,
        fold=fold,
        windindx0=wind0,
        K=jnp.asarray(K, dtype) if K is not None else jnp.zeros((0, 0), dtype),
        Kval=jnp.asarray(Kval, dtype) if Kval is not None else zero,
        epsl_yJ=jnp.asarray(epsl_yJ, dtype) if epsl_yJ is not None else zero,
        epsl_LHS_A=(
            jnp.asarray(epsl_A, dtype)
            if epsl_A is not None and epsl_sp_obj is None
            else jnp.zeros((0, 0), dtype)
        ),
        epsl_codes=jnp.asarray(epsl_codes, jnp.int32) if epsl_codes is not None else jnp.zeros((0,), jnp.int32),
        epsl_counts=(
            jax.ops.segment_sum(
                jnp.ones((len(epsl_codes),), dtype), jnp.asarray(epsl_codes, jnp.int32),
                num_segments=qe_pad if qe else qe,
            )
            if qe
            else zero
        ),
        epsl_sp=epsl_sp_obj,
    )


def _build_epsl_sparse(A, tile: int, dtype) -> tuple:
    """Pack a scipy sparse symmetric A into EpslSparse: zero-padded (qe_pad)
    dense diagonal blocks + per-block COO triplets of A[:, block] (padded to
    the max per-block count), + the global COO for matvecs."""
    import scipy.sparse as sp_

    A = sp_.csc_matrix(A)
    q = A.shape[0]
    nbr = -(-q // tile)
    qe_pad = nbr * tile
    diag_blocks = np.zeros((nbr, tile, tile), dtype=np.float64)
    blk_r, blk_c, blk_v = [], [], []
    for i in range(nbr):
        c0, c1 = i * tile, min(q, (i + 1) * tile)
        blk = A[:, c0:c1].tocoo()
        # FORWARD-only triplets (row >= block end): the sweep recomputes the
        # residual from scratch every call, so scatter updates to rows of
        # already-swept blocks are never read — in-block coupling is handled
        # by the dense diagonal block, backward rows are dead.  Halves the
        # scatter mass of a symmetric A on average.
        fwd = blk.row >= c1
        blk_r.append(blk.row[fwd].astype(np.int32))
        blk_c.append(blk.col[fwd].astype(np.int32))
        blk_v.append(blk.data[fwd])
        d = A[c0:c1, c0:c1].toarray()
        diag_blocks[i, : d.shape[0], : d.shape[1]] = d
    P = max(max((len(r) for r in blk_r), default=1), 1)
    rows = np.zeros((nbr, P), dtype=np.int32)
    cols = np.zeros((nbr, P), dtype=np.int32)
    vals = np.zeros((nbr, P), dtype=np.float64)
    for i in range(nbr):
        k = len(blk_r[i])
        rows[i, :k] = blk_r[i]
        cols[i, :k] = blk_c[i]
        vals[i, :k] = blk_v[i]
    coo = A.tocoo()
    sp_obj = EpslSparse(
        diag_blocks=jnp.asarray(diag_blocks, dtype),
        blk_rows=jnp.asarray(rows),
        blk_cols=jnp.asarray(cols),
        blk_vals=jnp.asarray(vals, dtype),
        coo_rows=jnp.asarray(coo.row.astype(np.int32)),
        coo_cols=jnp.asarray(coo.col.astype(np.int32)),
        coo_vals=jnp.asarray(coo.data, dtype),
    )
    return sp_obj, qe_pad


def init_state(spec: GibbsSpec, data: GibbsData, priors: Priors, pi_init) -> ChainState:
    dt = data.y.dtype
    n, m_pad = spec.n, spec.m_pad
    nr = len(spec.nlevels)
    mu0 = jnp.mean(data.y)
    yadj0 = data.y - mu0
    pi = jnp.asarray(pi_init, dt)
    vara_fold = (
        jnp.asarray(priors.varg, dt) * data.fold
        if spec.n_fold > 2 or spec.model == "BayesR"
        else jnp.ones((spec.n_fold,), dt)
    )
    need_vargl = spec.model_index == 5
    return ChainState(
        it=jnp.zeros((), jnp.int32),
        mu=mu0,
        beta=jnp.zeros((spec.nc,), dt),
        estR=tuple(jnp.zeros((nl,), dt) for nl in spec.nlevels),
        vrtmp=jnp.full((nr,), priors.vr_init, dt),
        vr=jnp.zeros((nr,), dt),
        yadj=yadj0,
        u=jnp.zeros((n,), dt),
        g=jnp.zeros((m_pad,), dt),
        varg=jnp.asarray(priors.varg, dt),
        vargL=jnp.full((m_pad,), priors.varg, dt) if need_vargl else jnp.zeros((0,), dt),
        lambda2=jnp.asarray(priors.lambda2, dt),
        pi=pi,
        vara_fold=vara_fold,
        vara=jnp.asarray(priors.vara, dt),
        vare=jnp.asarray(priors.vare, dt),
        track=jnp.zeros((m_pad,), jnp.int32),
        nzrate=jnp.zeros((m_pad,), dt),
        wppa=jnp.zeros((spec.nw,), dt),
        k_estR=jnp.zeros((n,), dt) if spec.use_bslmm else jnp.zeros((0,), dt),
        vbtmp=jnp.asarray(priors.vara, dt),
        va=jnp.asarray(priors.varg, dt),
        vb=jnp.asarray(priors.vara, dt),
        J_beta=jnp.zeros((), dt),
        epsl_estR=jnp.zeros((spec.qe_pad or spec.qe,), dt),
        vepstmp=jnp.asarray(priors.vara, dt),
        veps=jnp.asarray(priors.vara, dt),
    )


def _snapshot(spec: GibbsSpec, state: ChainState):
    vt = state.vara + state.vare + jnp.sum(state.vr)
    snap = {
        "mu": state.mu,
        "pi": state.pi,
        "Vg": state.vara,
        "Ve": state.vare,
        "h2": state.vara / vt,
        "alpha": state.g,
        "beta": state.beta,
        "Vr": state.vr,
        "r": jnp.concatenate(state.estR) if state.estR else jnp.zeros((0,), state.g.dtype),
        "lambda": jnp.sqrt(state.lambda2),
    }
    if spec.use_bslmm:
        snap["Va"] = state.va
        snap["Vb"] = state.vb
        snap["k_estR"] = state.k_estR
    if spec.qe:
        snap["Veps"] = state.veps
        snap["J"] = state.J_beta
        snap["epsilon"] = state.epsl_estR[: spec.qe]
    return snap


@partial(jax.jit, static_argnums=(0, 4))
def _run_all(spec: GibbsSpec, data: GibbsData, base_key, state: ChainState,
             mesh=None):
    step = lambda s: one_iteration(spec, data, base_key, s, mesh=mesh)

    state = jax.lax.fori_loop(0, spec.nburn, lambda i, s: step(s), state)

    def record_body(state, _):
        state = jax.lax.fori_loop(0, spec.thin, lambda i, s: step(s), state)
        return state, _snapshot(spec, state)

    state, samples = jax.lax.scan(record_body, state, None, length=spec.n_records)
    return state, samples


@partial(jax.jit, static_argnums=(0, 1, 5))
def _run_burn_segment(spec: GibbsSpec, k: int, data: GibbsData, base_key, state,
                      mesh=None):
    step = lambda s: one_iteration(spec, data, base_key, s, mesh=mesh)
    return jax.lax.fori_loop(0, k, lambda i, s: step(s), state)


@partial(jax.jit, static_argnums=(0, 1, 5))
def _run_record_segment(spec: GibbsSpec, k: int, data: GibbsData, base_key, state,
                        mesh=None):
    step = lambda s: one_iteration(spec, data, base_key, s, mesh=mesh)

    def record_body(state, _):
        state = jax.lax.fori_loop(0, spec.thin, lambda i, s: step(s), state)
        return state, _snapshot(spec, state)

    return jax.lax.scan(record_body, state, None, length=k)


def _it_of(state) -> int:
    """Iteration counter: scalar for one chain, it[0] for a batched state
    (all chains share the counter)."""
    return int(np.asarray(state.it).reshape(-1)[0])


def _run_segmented(spec, data, base_key, state0, checkpoint_path, chunk_records,
                   verbose, mesh=None, burn_fn=None, record_fn=None):
    """Chunked execution with checkpointing + reference-style progress rows
    (iter / NnzSnp / pi / Vg / Ve / h2 / time left — src/Bayes.cpp:884-914).
    Engine-agnostic: the summary engine reuses it by passing its own
    burn/record segment functions (state only needs .it/.track/.pi/.vara/
    .vare leaves for the progress row), and multi-chain runners pass batched
    segment functions (leaves carry a leading K axis)."""
    import time as _time

    from .checkpoint import load_checkpoint, save_checkpoint

    if burn_fn is None:
        burn_fn = lambda sp, k, d, key, st: _run_burn_segment(sp, k, d, key, st, mesh)
    if record_fn is None:
        record_fn = lambda sp, k, d, key, st: _run_record_segment(sp, k, d, key, st, mesh)

    state = state0
    samples_parts = []
    n_done_records = 0
    if checkpoint_path:
        loaded = load_checkpoint(checkpoint_path, state0)
        if loaded is not None:
            state, prev = loaded
            if prev:
                samples_parts.append(prev)
                n_done_records = next(iter(prev.values())).shape[0]
            if verbose:
                print(f"resumed from iteration {_it_of(state)} "
                      f"({n_done_records} records collected)")

    t0 = _time.time()
    total_iters = spec.niter_eff

    def eta(it_done):
        if it_done <= 0:
            return "--"
        rate = (_time.time() - t0) / it_done
        sec = int(rate * (total_iters - _it_of(state)))
        return f"{sec // 3600:02d}h{sec % 3600 // 60:02d}m{sec % 60:02d}s"

    it_at_start = _it_of(state)
    # finish burn-in in chunks
    burn_chunk = max(chunk_records * spec.thin, 1)
    while _it_of(state) < spec.nburn:
        k = min(burn_chunk, spec.nburn - _it_of(state))
        state = jax.block_until_ready(
            burn_fn(spec, k, data, base_key, state)
        )
        if checkpoint_path:
            save_checkpoint(checkpoint_path, state, _concat_samples(samples_parts))
        if verbose:
            _print_progress(spec, state, eta(_it_of(state) - it_at_start))
    # record phase in chunks
    while n_done_records < spec.n_records:
        k = min(chunk_records, spec.n_records - n_done_records)
        state, chunk = record_fn(spec, k, data, base_key, state)
        state, chunk = jax.block_until_ready((state, chunk))
        samples_parts.append({kk: np.asarray(v) for kk, v in chunk.items()})
        n_done_records += k
        if checkpoint_path:
            save_checkpoint(checkpoint_path, state, _concat_samples(samples_parts))
        if verbose:
            _print_progress(spec, state, eta(_it_of(state) - it_at_start))
    return state, _concat_samples(samples_parts)


def _concat_samples(parts):
    if not parts:
        return {}
    keys = parts[0].keys()
    return {k: np.concatenate([p[k] for p in parts], axis=0) for k in keys}


def _print_progress(spec, state, eta_str):
    # reduce on device: np.asarray(track) would ship the full m-length vector
    # across the host link on every progress row (real cost at m-MP scale)
    batched = np.asarray(state.it).ndim > 0  # multi-chain state: show chain 0
    track = state.track[0] if batched else state.track
    nnz = int(jnp.sum(track > 0))
    if spec.model_index in (1, 2, 5):
        nnz = spec.m - spec.nvar0
    pi = np.asarray(state.pi)[0] if batched else np.asarray(state.pi)
    vara = float(np.asarray(state.vara).reshape(-1)[0])
    vare = float(np.asarray(state.vare).reshape(-1)[0])
    pi_str = " ".join(f"{p:.4f}" for p in pi)
    vt = vara + vare
    tag = f"  [chain 1/{len(np.asarray(state.it))}]" if batched else ""
    print(
        f" {_it_of(state):>6d}  {nnz:>6d}  {pi_str}  "
        f"Vg {vara:.4f}  Ve {vare:.4f}  "
        f"h2 {vara / max(vt, 1e-30):.4f}  {eta_str}{tag}"
    )


def run_chain(spec: GibbsSpec, data: GibbsData, priors: Priors, pi_init, seed=666666,
              mesh=None, checkpoint_path=None, chunk_records=0, progress=False):
    """Run the full chain; returns (final_state, samples dict, summaries dict).

    samples arrays have leading axis n_records; alpha is sliced to the real m.
    With `mesh`, the individual axis is sharded across devices (exact chain,
    psum-merged contractions).  With `checkpoint_path` or `progress`,
    execution is chunked (`chunk_records` records per device call): state +
    collected samples are persisted after each chunk and a killed chain
    resumes bit-identically (randomness is keyed off the iteration counter).
    """
    base_key = jax.random.PRNGKey(seed)
    segmented = checkpoint_path is not None or progress
    if chunk_records <= 0:
        chunk_records = max(spec.n_records // 10, 1)
    if mesh is not None:
        from ..parallel.mesh import shard_gibbs_data, shard_state

        data = shard_gibbs_data(data, mesh)
        state0 = shard_state(init_state(spec, data, priors, pi_init), mesh)
        with mesh:
            if segmented:
                state, samples = _run_segmented(
                    spec, data, base_key, state0, checkpoint_path, chunk_records,
                    progress, mesh=mesh,
                )
            else:
                state, samples = _run_all(spec, data, base_key, state0, mesh)
    else:
        state0 = init_state(spec, data, priors, pi_init)
        if segmented:
            state, samples = _run_segmented(
                spec, data, base_key, state0, checkpoint_path, chunk_records,
                progress,
            )
        else:
            state, samples = _run_all(spec, data, base_key, state0)
    state, samples = jax.block_until_ready((state, samples))
    if not np.isfinite(np.asarray(state.vare)).all():
        import warnings

        warnings.warn(
            "chain diverged: residual variance is non-finite at the final "
            "iteration"
            + (" — the relaxed shard_schedule='concurrent' kernel is a "
               "known divergence source in the m > n regime; rerun with "
               "'pipeline' or 'turn'"
               if spec.shard_schedule == "concurrent" else ""),
            UserWarning, stacklevel=2,
        )

    nzct = spec.n_records * spec.thin
    pip = state.nzrate / nzct
    # clamp PIP == 1 to (nzct-1)/nzct (src/Bayes.cpp:1030)
    pip = jnp.where(pip >= 1.0, (nzct - 1.0) / nzct, pip)
    if spec.model_index in (1, 2, 5):
        pip = jnp.ones_like(pip)
    wppa = state.wppa / nzct
    wppa = jnp.where(wppa >= 1.0, (nzct - 1.0) / nzct, wppa)

    samples = dict(samples)
    samples["alpha"] = samples["alpha"][:, : spec.m]
    extras = {"pip": pip[: spec.m], "wppa": wppa, "nzct": nzct}
    return state, samples, extras


# ---------------------------------------------------------------------------
# multi-chain execution
# ---------------------------------------------------------------------------


def one_iteration_batch(spec: GibbsSpec, data: GibbsData, chain_keys, states,
                        mesh=None):
    """One iteration of K chains.  The cheap phases vmap; the SNP sweep runs
    the per-block draws kernel for all K chains at once (`_sweep_kernel_mc`,
    inside shard_map under an ind-sharded mesh), else the vmapped XLA sweep.
    Under an SNP-sharded mesh the sweep runs the turn-based shard schedule
    with all K chains per turn (_sweep_snp_sharded_mc) — m-MP composes with
    multi-chain batching."""
    keys = jax.vmap(lambda k, it: jax.random.fold_in(k, it))(chain_keys, states.it)
    pre = jax.vmap(lambda k, s: _pre_sweep(spec, data, k, s))(keys, states)
    z_b, u_b, chi_b, z2_b = pre["rnd"]
    args = (spec, pre["consts"], data.X_blocks, data.W_blocks, data.xpx,
            data.vx, pre["vei"], states.g, z_b, u_b, chi_b, z2_b,
            pre["vargL_in"], pre["yadj"], pre["u"])
    ind_sharded = ind_shard_count(mesh) > 1

    if snp_shard_count(spec.nblocks, mesh) > 1:
        sweep_out = _sweep_snp_sharded_mc(
            spec, data, pre["consts"], pre["rnd"], pre["vei"], states.g,
            pre["vargL_in"], pre["yadj"], pre["u"], mesh,
        )
    elif (spec.shard_schedule in ("concurrent", "pipeline")
            and spec.emulate_shards > 1 and not ind_sharded):
        emu = (_sweep_concurrent_emu_mc
               if spec.shard_schedule == "concurrent"
               else _sweep_pipeline_emu_mc)
        sweep_out = emu(*args)
    elif _kernel_draws(spec, data.y.dtype):
        sweep_out = _sweep_kernel_mc(*args, mesh=mesh if ind_sharded else None)
    else:
        sweep_out = jax.vmap(
            lambda c, r, vei, g, vl, ya, uu: _sweep_xla(spec, data, c, r, vei, g, vl, ya, uu)
        )(pre["consts"], pre["rnd"], pre["vei"], states.g, pre["vargL_in"],
          pre["yadj"], pre["u"])

    return _post_sweep_batch(spec, data, keys, states, pre, sweep_out)



def _post_sweep_batch(spec: GibbsSpec, data: GibbsData, keys, states, pre,
                      sweep_out):
    """Vmapped post-sweep + scalar-predicate drift resync for K chains."""
    dt = data.y.dtype
    new_states = jax.vmap(
        lambda k, s, p, so: _post_sweep(spec, data, k, s, p, so, inline_resync=False)
    )(keys, states, pre, sweep_out)

    # drift resync with a SCALAR predicate (all chains share the iteration
    # counter); a vmapped per-chain cond would lower to select and run the
    # full-genotype recompute every iteration
    if spec.resync_every and dt == jnp.float32:
        def do_resync(ss):
            ya, uu = jax.vmap(
                lambda s: _recompute_residuals(
                    spec, data, s.mu, s.beta, s.estR, s.k_estR, s.J_beta,
                    s.epsl_estR, s.g,
                )
            )(ss)
            return ss._replace(yadj=ya, u=uu)

        it_prev = new_states.it[0] - 1
        new_states = jax.lax.cond(
            (it_prev % spec.resync_every) == spec.resync_every - 1,
            do_resync, lambda ss: ss, new_states,
        )
    return new_states


@partial(jax.jit, static_argnums=(0, 4))
def _run_all_multi(spec: GibbsSpec, data: GibbsData, chain_keys, states,
                   mesh=None):
    """K independent chains batched: per-block matvecs become (K,n)x(n,B)
    products and every draw vectorises across chains.
    The reference runs a single chain only."""
    step = lambda ss: one_iteration_batch(spec, data, chain_keys, ss, mesh=mesh)

    states = jax.lax.fori_loop(0, spec.nburn, lambda i, ss: step(ss), states)

    def record_body(ss, _):
        ss = jax.lax.fori_loop(0, spec.thin, lambda i, s2: step(s2), ss)
        return ss, jax.vmap(lambda s1: _snapshot(spec, s1))(ss)

    states, samples = jax.lax.scan(record_body, states, None, length=spec.n_records)
    # scan stacks records first: (n_records, K, ...) -> (K, n_records, ...)
    samples = jax.tree_util.tree_map(lambda x: jnp.swapaxes(x, 0, 1), samples)
    return states, samples


@partial(jax.jit, static_argnums=(0, 1, 5))
def _run_burn_segment_multi(spec: GibbsSpec, k: int, data: GibbsData,
                            chain_keys, states, mesh=None):
    step = lambda ss: one_iteration_batch(spec, data, chain_keys, ss, mesh=mesh)
    return jax.lax.fori_loop(0, k, lambda i, ss: step(ss), states)


@partial(jax.jit, static_argnums=(0, 1, 5))
def _run_record_segment_multi(spec: GibbsSpec, k: int, data: GibbsData,
                              chain_keys, states, mesh=None):
    step = lambda ss: one_iteration_batch(spec, data, chain_keys, ss, mesh=mesh)

    def record_body(ss, _):
        ss = jax.lax.fori_loop(0, spec.thin, lambda i, s2: step(s2), ss)
        return ss, jax.vmap(lambda s1: _snapshot(spec, s1))(ss)

    # records-major (k, K, ...) so segmented chunks concatenate on axis 0;
    # the caller swaps to (K, n_records, ...) at the end
    return jax.lax.scan(record_body, states, None, length=k)


def run_chains(spec: GibbsSpec, data: GibbsData, priors: Priors, pi_init,
               seed=666666, nchains=4, mesh=None, checkpoint_path=None,
               progress=False, chunk_records=0):
    """Run `nchains` independent chains (distinct PRNG streams, identical
    data/priors).  Returns (states, samples, extras) where samples arrays
    have leading axes (nchains, n_records, ...), plus per-parameter R-hat
    (Gelman-Rubin) diagnostics in extras.  With `checkpoint_path` or
    `progress`, execution is chunked: the batched state + collected samples
    persist after each chunk and a killed multi-chain run resumes
    bit-identically (randomness keys off each chain's iteration counter)."""
    base = jax.random.PRNGKey(seed)
    chain_keys = jax.random.split(base, nchains)
    state0 = init_state(spec, data, priors, pi_init)
    states0 = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (nchains,) + x.shape), state0
    )
    segmented = checkpoint_path is not None or progress
    if chunk_records <= 0:
        chunk_records = max(spec.n_records // 10, 1)
    burn_fn = lambda sp, k, d, key, st: _run_burn_segment_multi(
        sp, k, d, chain_keys, st, mesh)
    record_fn = lambda sp, k, d, key, st: _run_record_segment_multi(
        sp, k, d, chain_keys, st, mesh)
    if mesh is not None:
        from ..parallel.mesh import shard_gibbs_data

        data = shard_gibbs_data(data, mesh)
        with mesh:
            if segmented:
                states, samples = _run_segmented(
                    spec, data, None, states0, checkpoint_path, chunk_records,
                    progress, mesh=mesh, burn_fn=burn_fn, record_fn=record_fn,
                )
            else:
                states, samples = _run_all_multi(spec, data, chain_keys, states0, mesh)
    elif segmented:
        states, samples = _run_segmented(
            spec, data, None, states0, checkpoint_path, chunk_records,
            progress, burn_fn=burn_fn, record_fn=record_fn,
        )
    else:
        states, samples = _run_all_multi(spec, data, chain_keys, states0)
    states, samples = jax.block_until_ready((states, samples))
    bad = ~np.isfinite(np.asarray(states.vare))
    if bad.any():
        import warnings

        warnings.warn(
            f"{int(bad.sum())}/{nchains} chains diverged (non-finite "
            "residual variance at the final iteration)"
            + (" — the relaxed shard_schedule='concurrent' kernel is a "
               "known divergence source in the m > n regime; rerun with "
               "'pipeline' or 'turn'"
               if spec.shard_schedule == "concurrent" else ""),
            UserWarning, stacklevel=2,
        )
    if segmented:
        # segmented chunks are records-major: (n_records, K, ...) -> (K, n_records, ...)
        samples = {k: np.swapaxes(np.asarray(v), 0, 1) for k, v in samples.items()}

    nzct = spec.n_records * spec.thin
    pip = states.nzrate / nzct  # (nchains, m_pad)
    pip = jnp.where(pip >= 1.0, (nzct - 1.0) / nzct, pip)
    if spec.model_index in (1, 2, 5):
        pip = jnp.ones_like(pip)
    wppa = states.wppa / nzct
    wppa = jnp.where(wppa >= 1.0, (nzct - 1.0) / nzct, wppa)

    samples = dict(samples)
    samples["alpha"] = samples["alpha"][:, :, : spec.m]
    # reductions on device, ndim checked without np.asarray: anything else
    # ships the full (K, n_records, m) sample tensors across the host link
    extras = {
        "pip": np.asarray(pip[:, : spec.m].mean(axis=0)),
        "wppa": np.asarray(wppa.mean(axis=0)),
        "nzct": nzct,
        "rhat": rhat_diagnostics(samples),
    }
    return states, samples, extras


def rhat_diagnostics(samples, max_entries=256) -> dict:
    """Split-R-hat per sampled parameter: scalars directly, vector parameters
    (alpha, GEBV-like traces) as the MAX split-R-hat over `max_entries`
    evenly-subsampled entries — the convergence summary practitioners monitor
    at scale.  Subsampling happens on device so the (K, n_records, m) sample
    tensors never cross the host link."""
    out = {}
    for k, v in samples.items():
        nd = getattr(v, "ndim", 0)
        if nd == 2:
            out[k] = gelman_rubin(np.asarray(v))
        elif nd == 3 and v.shape[2] > 0 and v.shape[1] >= 4:
            idx = np.unique(
                np.linspace(0, v.shape[2] - 1, min(v.shape[2], max_entries))
                .astype(int)
            )
            sub = np.asarray(v[:, :, idx], dtype=np.float64)
            vals = [gelman_rubin(sub[:, :, j]) for j in range(sub.shape[2])]
            vals = [r for r in vals if np.isfinite(r)]
            out[k] = float(max(vals)) if vals else float("nan")
    return out


def gelman_rubin(chains: np.ndarray) -> float:
    """Split-R-hat over (nchains, n_records) scalar samples."""
    x = np.asarray(chains, dtype=np.float64)
    if x.ndim != 2 or x.shape[1] < 4:
        return float("nan")
    half = x.shape[1] // 2
    splits = np.concatenate([x[:, :half], x[:, half: 2 * half]], axis=0)
    k, n_ = splits.shape
    means = splits.mean(axis=1)
    w = splits.var(axis=1, ddof=1).mean()
    b = n_ * means.var(ddof=1)
    if w <= 0:
        return float("nan")
    var_plus = (n_ - 1) / n_ * w + b / n_
    return float(np.sqrt(var_plus / w))
