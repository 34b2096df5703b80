"""Pallas-Triton kernels for the sequential draws of the blocked Gibbs sweep.

Every engine sweeps SNP blocks of B in a `lax.scan`: r0 = X_b' yadj (or the
r_hat slice), the B sequential draws, then one residual product.  Only the
draws are sequential, and in every alphabet member the only quantity they
read from the moving residual is rhs = dot(X_j, yadj); everything else
depends on per-SNP inputs known before the sweep.  So:

  phase A (XLA, vectorised over all m): `_pack_rows` packs each SNP's
     coefficients into rows — conditional precision, sd*z, the spike/slab
     acceptance rewritten exp-free (u >= 1/(1+exp(s1-s0)) <=> rhs^2 >=
     thresh_j, src/Bayes.cpp:643-645), the BayesR fold logits A_f + B_f rhs^2
     with Gumbel noise folded into A_f (src/Bayes.cpp:747-766);
  phase B (`block_draws`, this kernel): the B draws of one block for a tile
     of chains, rhs_j = r0_j + xpx_j g_j + sum_{i<j} W[j,i] dg_i;
  phase C (XLA, vectorised): `_phase_c*` — BayesL local variances (they feed
     only the next sweep), variance accumulators.

The kernel loops over micro-blocks of 16 draws: at each micro-block start
one full-f32 product W[j0:j0+16, :] @ dg folds in every earlier draw (rows
>= j0 of dg are still zero); within it the i < j terms are a 16-row
reduction per draw.  Chains are independent, so the grid runs over
tiles of 16 chains.  The per-SNP XLA scan (`engine/gibbs._snp_scan_step`)
is the reference; tests/test_draws_kernel.py checks the kernel against it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .. import runtime
from ..engine.gibbs import HIGHEST, GibbsSpec

F32 = jnp.float32
NEG_BIG = -1e30
POS_BIG = 1e30

# chains per program: pl.dot needs every dimension >= 16
CHAIN_TILE = 16
# draws per micro-block of the in-block correction
MICRO = 16
# measured best of 1/2/4 warps on the H100 (PERF.md, PR 1)
NUM_WARPS = 2


def _pack_rows(spec: GibbsSpec, consts, xpx, vx, vei, g, z_snp, u_snp, chi_snp):
    """Phase A: per-SNP coefficient rows, shape (R, m_pad).  Row order:
    [rg, g_old, inv_v, sz, (thresh | per-fold A/B/inv_v/sz..., A0)].
    For BayesR ``u_snp`` carries (m_pad, n_fold) uniforms — one per fold —
    transformed to Gumbel noise and folded into the A rows (Gumbel-max
    categorical); other models consume the usual (m_pad,) uniform."""
    mi = spec.model_index
    dt = F32
    x = xpx.astype(dt)
    ve = vei.astype(dt)
    act = vx > 0
    g = g.astype(dt)
    rg = x * g
    s2varg_df = consts["s2varg_df"].astype(dt)

    def cond_coeffs(varg):
        v = x + ve / varg
        inv_v = jnp.where(act, 1.0 / v, 0.0)
        sz = jnp.where(act, jnp.sqrt(ve / v) * z_snp.astype(dt), 0.0)
        return v, inv_v, sz

    if mi == 1:
        v, inv_v, sz = cond_coeffs(consts["varg"].astype(dt))
        rows = [rg, g, inv_v, sz]
    elif mi == 2:
        vargj = (g * g + s2varg_df) / chi_snp.astype(dt)
        v, inv_v, sz = cond_coeffs(vargj)
        rows = [rg, g, inv_v, sz]
    elif mi in (3, 4):
        vargj = (
            (g * g + s2varg_df) / chi_snp.astype(dt)
            if mi == 3
            else consts["varg"].astype(dt)
        )
        v, inv_v, sz = cond_coeffs(vargj)
        logdetV = jnp.log(vargj * x / ve + 1.0)
        uu = u_snp.astype(dt)
        Lu = jnp.log((1.0 - uu) / jnp.maximum(uu, 1e-37))
        dlogpi = consts["logpi"][1] - consts["logpi"][0]
        thresh = 2.0 * v * ve * (Lu + 0.5 * logdetV - dlogpi)
        thresh = jnp.where(act, thresh, POS_BIG)
        rows = [rg, g, inv_v, sz, thresh]
    elif mi == 5:
        vargL = consts["vargL_vec"].astype(dt)
        v = x + 1.0 / vargL
        inv_v = jnp.where(act, 1.0 / v, 0.0)
        sz = jnp.where(act, jnp.sqrt(ve / v) * z_snp.astype(dt), 0.0)
        rows = [rg, g, inv_v, sz]
    else:  # BayesR — Gumbel-max categorical fold draw.  The fold logits are
        # s_f = A_f + B_f rhs^2 (exact rewrite of src/Bayes.cpp:747-766); the
        # categorical draw argmax_f(s_f + G_f) with iid Gumbel noise G_f is
        # distribution-identical to the inverse-CDF draw but needs no
        # exp/normalise/cumsum in the sequential chain — the Gumbels fold
        # into A_f here in phase A, the per-draw work is n_fold FMAs+compares.
        ut = jnp.maximum(u_snp.astype(dt).T, 1e-12)     # (n_fold, m_pad)
        gum = -jnp.log(-jnp.log(ut))
        rows = [rg, g]
        for f in range(1, spec.n_fold):
            vara_f = jnp.maximum(consts["vara_fold"][f], 1e-30).astype(dt)
            vf = x + ve / vara_f
            A_f = -0.5 * jnp.log(vara_f * x / ve + 1.0) + consts["logpi"][f]
            A_f = A_f + gum[f]
            A_f = jnp.where(act, A_f, NEG_BIG)
            B_f = 0.5 / (vf * ve)
            ivf = jnp.where(act, 1.0 / vf, 0.0)
            szf = jnp.where(act, jnp.sqrt(ve / vf) * z_snp.astype(dt), 0.0)
            rows += [A_f, B_f, ivf, szf]
        rows.append(consts["logpi"][0] + gum[0])        # fold-0 gumbel logit
    return jnp.stack(rows).astype(dt)  # (R, m_pad)


# ---------------------------------------------------------------------------
# SBayesS rejection guard: N_RETRY precomputed retry draws per SNP (the
# reference retries <= 100 times from the same conditional then zeroes,
# src/SBayesS.cpp:388-398; bounded retries with independent normals are the
# same truncation up to the tail probability)
# ---------------------------------------------------------------------------

N_RETRY = 8
STREAM_SNP_ZR = 15  # retry-normal stream (engine/gibbs.py stream registry)


def guard_on(spec: GibbsSpec) -> bool:
    return bool(spec.reject_guard) and spec.model_index in (4, 6)


def _guard_base(spec: GibbsSpec) -> int:
    """Index of the first guard row (vx) appended after the _pack_rows rows."""
    mi = spec.model_index
    if mi in (1, 2, 5):
        return 4
    if mi in (3, 4):
        return 5
    return 2 + 4 * (spec.n_fold - 1) + 1  # BayesR: [rg,g, (A,B,iv,sz)*, A0]


def _pack_retry_rows(spec: GibbsSpec, consts, xpx, vx, vei, z_retry):
    """Guard rows: [vx, sd*z_1 .. sd*z_NR] (BayesC) or
    [vx, (sd_f*z_1)_f .. (sd_f*z_NR)_f] (BayesR, folds 1..nf-1)."""
    mi = spec.model_index
    x = xpx.astype(F32)
    ve = vei.astype(F32)
    act = vx > 0
    rows = [vx.astype(F32)]
    if mi == 4:
        v = x + ve / consts["varg"].astype(F32)
        sd = jnp.where(act, jnp.sqrt(ve / v), 0.0)
        for r in range(N_RETRY):
            rows.append(sd * z_retry[r].astype(F32))
    elif mi == 6:
        sds = []
        for f in range(1, spec.n_fold):
            vara_f = jnp.maximum(consts["vara_fold"][f], 1e-30).astype(F32)
            vf = x + ve / vara_f
            sds.append(jnp.where(act, jnp.sqrt(ve / vf), 0.0))
        for r in range(N_RETRY):
            for f in range(1, spec.n_fold):
                rows.append(sds[f - 1] * z_retry[r].astype(F32))
    return jnp.stack(rows)


def retry_normals(key, m_pad: int):
    """(N_RETRY, m_pad) guard retry normals of one iteration (drawn for the
    whole genome so every shard layout sees the same stream)."""
    return jax.random.normal(jax.random.fold_in(key, STREAM_SNP_ZR),
                             (N_RETRY, m_pad), dtype=F32)


def pack_draw_rows(spec: GibbsSpec, consts, xpx, vx, vei, g, z_snp, u_snp,
                   chi_snp, z_retry=None):
    """`_pack_rows` plus, when the rejection guard is on, its retry rows
    built from `z_retry` (N_RETRY, m) — see `retry_normals`."""
    P = _pack_rows(spec, consts, xpx, vx, vei, g, z_snp, u_snp, chi_snp)
    if not guard_on(spec):
        return P
    return jnp.concatenate(
        [P, _pack_retry_rows(spec, consts, xpx, vx, vei, z_retry)])


def to_block_layout(P, nblocks, B):
    """(K, R, m_pad) packed rows -> (nblocks, B, R, Kp): the draw kernel's
    operand layout, chains padded to whole tiles of CHAIN_TILE (padding
    chains draw from all-zero rows: finite, never read)."""
    K, R = P.shape[0], P.shape[1]
    Kp = -(-K // CHAIN_TILE) * CHAIN_TILE
    if Kp != K:
        P = jnp.pad(P, ((0, Kp - K), (0, 0), (0, 0)))
    return P.reshape(Kp, R, nblocks, B).transpose(2, 3, 1, 0)


def _draw_from_vals(spec: GibbsSpec, vals, rhs):
    """One draw over packed coefficient values vals(r) (any shape, e.g. a
    chain tile) -> (gi, track or None)."""
    mi = spec.model_index
    nf = spec.n_fold
    if mi in (1, 2):
        return rhs * vals(2) + vals(3), None
    if mi in (3, 4):
        ind = rhs * rhs >= vals(4)
        gi = jnp.where(ind, rhs * vals(2) + vals(3), 0.0)
        return gi, ind.astype(F32)
    if mi == 5:
        gi = rhs * vals(2) + vals(3)
        gi = jnp.where(jnp.abs(gi) < 1e-6, jnp.float32(1e-6), gi)
        gi = jnp.where(vals(2) > 0, gi, 0.0)
        return gi, None
    # BayesR: Gumbel-max fold selection — the Gumbel noise is already folded
    # into the A rows by _pack_rows, so the fold draw is argmax_f(A_f+B_f q)
    # with no transcendentals.  The per-fold logits and candidate draws are
    # independent FMAs; the argmax runs as a balanced tournament so the
    # serial dependency depth is O(log nf).
    q = rhs * rhs
    cand = [(vals(2 + 4 * (nf - 1)) + 0.0 * rhs,       # s_0 (gumbel logit)
             jnp.zeros_like(rhs),                       # gi_0 = 0
             jnp.zeros_like(rhs, dtype=jnp.int32))]     # ind_0
    for f in range(1, nf):
        sf = vals(2 + 4 * (f - 1)) + vals(3 + 4 * (f - 1)) * q
        gif = rhs * vals(4 + 4 * (f - 1)) + vals(5 + 4 * (f - 1))
        cand.append((sf, gif, jnp.full_like(cand[0][2], f)))
    while len(cand) > 1:
        nxt = []
        for i in range(0, len(cand) - 1, 2):
            (sa, ga, ia), (sb, gb, ib) = cand[i], cand[i + 1]
            sel = sb > sa
            nxt.append((jnp.maximum(sa, sb), jnp.where(sel, gb, ga),
                        jnp.where(sel, ib, ia)))
        if len(cand) % 2:
            nxt.append(cand[-1])
        cand = nxt
    _, gi, ind = cand[0]
    return gi, ind.astype(F32)


def _guard_redraw(spec: GibbsSpec, vals, rhs, gi, track):
    """Rejection guard on the packed retry rows: while gi^2 vx > vary, take
    the next retry draw of the same conditional; zero after N_RETRY."""
    mi, nf = spec.model_index, spec.n_fold
    base = _guard_base(spec)
    vary = jnp.float32(spec.vary)
    vxj = vals(base)
    on = track > 0
    rej = (gi * gi * vxj > vary) & on
    for r in range(N_RETRY):
        if mi == 4:
            cand = rhs * vals(2) + vals(base + 1 + r)
        else:
            cand = jnp.zeros_like(gi)
            for f in range(1, nf):
                cf = (rhs * vals(4 + 4 * (f - 1))
                      + vals(base + 1 + r * (nf - 1) + (f - 1)))
                cand = jnp.where(track == f, cf, cand)
        gi = jnp.where(rej, cand, gi)
        rej = (gi * gi * vxj > vary) & on
    return jnp.where(rej, 0.0, gi)


def _draws_kernel(spec: GibbsSpec, B: int, P_ref, W_ref, r0_ref,
                  dg_ref, track_ref):
    """B sequential draws for one tile of chains.  P (B, R, Kt), W (B, B),
    r0 (B, Kt) -> dg = g_old - g_new (B, Kt), track (B, Kt).

    Two loops, each body traced once (a fully unrolled body makes the Triton
    compile take minutes): micro-blocks of MICRO draws, and the draws of a
    micro-block, which see earlier micro-blocks through one full-f32 product
    and their own micro-block through a (MICRO, Kt) reduction."""
    S, Kt = MICRO, CHAIN_TILE
    R = P_ref.shape[1]
    guard = guard_on(spec)
    rows_s = jax.lax.broadcasted_iota(jnp.int32, (S, Kt), 0)
    # one-hot (B, S) embedding of a micro-block's rows into the block
    embed_r = jax.lax.broadcasted_iota(jnp.int32, (B, S), 0)
    embed_c = jax.lax.broadcasted_iota(jnp.int32, (B, S), 1)
    dot = functools.partial(jax.lax.dot_general,
                            dimension_numbers=(((1,), (0,)), ((), ())),
                            precision=HIGHEST, preferred_element_type=F32)

    def micro(i, dg_all):
        j0 = pl.multiple_of(i * S, S)
        # every earlier draw's contribution (rows >= j0 of dg_all are zero)
        base = r0_ref[pl.ds(j0, S), :] + dot(W_ref[pl.ds(j0, S), :], dg_all)

        def load(j):
            return tuple(P_ref[j, r, :] for r in range(R))

        def draw(t, carry):
            dg_mb, tr_mb, cur = carry
            j = j0 + t
            # the next draw's rows load one step ahead: only rhs is serial
            nxt = load(jnp.minimum(j + 1, B - 1))

            def vals(r):
                return cur[r]

            sel = rows_s == t
            w_mb = W_ref[j, pl.ds(j0, S)]              # in-micro-block Gram row
            rhs = (jnp.sum(jnp.where(sel, base, 0.0), axis=0)
                   + jnp.sum(w_mb[:, None] * dg_mb, axis=0) + vals(0))
            gi, track = _draw_from_vals(spec, vals, rhs)
            if guard:
                gi = _guard_redraw(spec, vals, rhs, gi, track)
            dg_mb = jnp.where(sel, (vals(1) - gi)[None, :], dg_mb)
            if track is not None:
                tr_mb = jnp.where(sel, track[None, :], tr_mb)
            return dg_mb, tr_mb, nxt

        zeros = jnp.zeros((S, Kt), F32)
        dg_mb, tr_mb, _ = jax.lax.fori_loop(0, S, draw, (zeros, zeros, load(j0)))
        dg_ref[pl.ds(j0, S), :] = dg_mb
        track_ref[pl.ds(j0, S), :] = tr_mb
        onehot = (embed_r == j0 + embed_c).astype(F32)
        return dg_all + dot(onehot, dg_mb)

    jax.lax.fori_loop(0, B // S, micro, jnp.zeros((B, Kt), F32))


def draws_supported(spec: GibbsSpec, dtype) -> bool:
    """Whether `block_draws` covers this configuration (else: XLA scan)."""
    B = spec.block
    return dtype == F32 and B >= MICRO and B & (B - 1) == 0


def block_draws(spec: GibbsSpec, P_b, W, r0):
    """(dg, track) of one block's B sequential draws for K chains.
    P_b (B, R, Kp) from `to_block_layout`; W (B, B) Gram block; r0 (B, K)."""
    B, R, Kp = P_b.shape
    K = r0.shape[1]
    if Kp != K:
        r0 = jnp.pad(r0, ((0, 0), (0, Kp - K)))
    interp = runtime.interpret()
    tile = pl.BlockSpec((B, CHAIN_TILE), lambda c: (0, c))
    dg, track = pl.pallas_call(
        functools.partial(_draws_kernel, spec, B),
        grid=(Kp // CHAIN_TILE,),
        in_specs=[pl.BlockSpec((B, R, CHAIN_TILE), lambda c: (0, 0, c)),
                  pl.BlockSpec((B, B), lambda c: (0, 0)), tile],
        out_specs=(tile, tile),
        out_shape=(jax.ShapeDtypeStruct((B, Kp), F32),
                   jax.ShapeDtypeStruct((B, Kp), F32)),
        backend="triton",
        interpret=interp,
        compiler_params=(None if interp else pl_triton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1)),
        name="block_draws",
    )(P_b.astype(F32), W.astype(F32), r0.astype(F32))
    return dg[:, :K], track[:, :K]


def sweep_s_segment_t(spec: GibbsSpec, LD_seg, r_seg_kb, P_seg_blocks, n: int):
    """K-chain sweep of one padded LD segment: the XLA scan over blocks owns
    the (K, mc) r_hat state (rank-B updates as one product per block,
    SBayesD.cpp:264-267); the per-block kernel runs the B sequential draws.

    LD_seg (mc, mc); r_seg_kb (K, mc); P_seg_blocks (nblocks, B, R, Kp).
    Returns (dg (K, mc), track (K, mc), r_seg_new (K, mc))."""
    mc = LD_seg.shape[0]
    B = spec.block
    nblocks = mc // B
    K = r_seg_kb.shape[0]
    LD32 = LD_seg.astype(F32)
    nf32 = jnp.float32(n)

    def body(r_seg, xs):
        b, P_b = xs
        Wn = jax.lax.dynamic_slice(LD32, (b * B, b * B), (B, B)) * nf32
        r0 = jax.lax.dynamic_slice(r_seg, (0, b * B), (K, B)).T  # (B, K)
        dg, track = block_draws(spec, P_b, Wn, r0)
        cols = jax.lax.dynamic_slice(LD32, (0, b * B), (mc, B))  # (mc, B)
        upd = jax.lax.dot_general(
            dg, cols, (((0,), (1,)), ((), ())),
            preferred_element_type=F32, precision=HIGHEST,
        )                                                         # (K, mc)
        return r_seg + nf32 * upd, (dg, track)

    r_new, (dgs, tracks) = jax.lax.scan(
        body, r_seg_kb.astype(F32),
        (jnp.arange(nblocks), P_seg_blocks),
    )
    # (nblocks, B, K) -> (K, mc)
    dg = dgs.transpose(2, 0, 1).reshape(K, mc)
    track = tracks.transpose(2, 0, 1).reshape(K, mc).astype(jnp.int32)
    return dg, track, r_new


def _phase_c_mc(spec, consts_b, vx, vei_b, g_new, track, u_b, z2_b, vargL_b,
                yadj_o, u_o):
    """Order-independent post-sweep state for the K-chain sweeps."""
    mi = spec.model_index
    K = g_new.shape[0]
    act = vx > 0
    if mi == 4:
        vargi_acc = jnp.sum(jnp.where(track == 1, g_new * g_new, 0.0), axis=1)
    else:
        vargi_acc = jnp.zeros((K,), F32)
    if mi == 6:
        ffold = jax.vmap(lambda f, t: f[t])(consts_b["fold"], track)
        vargR_acc = jnp.sum(
            jnp.where(track > 0, g_new * g_new / jnp.maximum(ffold, 1e-30), 0.0),
            axis=1,
        )
    else:
        vargR_acc = jnp.zeros((K,), F32)
    if mi == 5:
        lam2 = consts_b["lambda2"].astype(F32).reshape(K, 1)
        lam = jnp.sqrt(lam2)
        ve = vei_b.astype(F32)
        znew = z2_b.astype(F32)
        uu = u_b.astype(F32)
        mu_ig = jnp.sqrt(ve) * lam / jnp.maximum(jnp.abs(g_new), 1e-30)
        y2 = znew * znew
        xig = mu_ig + 0.5 * mu_ig * mu_ig * y2 / lam2 - 0.5 * (mu_ig / lam2) * jnp.sqrt(
            4.0 * mu_ig * lam2 * y2 + mu_ig * mu_ig * y2 * y2
        )
        ig = jnp.where(uu <= mu_ig / (mu_ig + xig), xig, mu_ig * mu_ig / xig)
        vargi = 1.0 / ig
        ok = (vargi > 0) if spec.vargl_strict_pos else (vargi >= 0)
        vargL_new = jnp.where(act[None, :] & ok, vargi, vargL_b.astype(F32))
    else:
        vargL_new = vargL_b.astype(F32)
    return (g_new, track, vargL_new, yadj_o, u_o, vargi_acc, vargR_acc)


# ---------------------------------------------------------------------------
# MME single-site block draws: the epsilon-term (single-step ssbrm) analogue
# of the SNP draw kernel.  One T-site block's sequential Gaussian draws with
# the same micro-block correction as `_draws_kernel`; the chain is a single
# scalar sequence.  Reference analogue: src/solver.cpp:131-140.
# ---------------------------------------------------------------------------


def _mme_kernel(T: int, W_ref, r_ref, invd_ref, noise_ref, dx_ref):
    """dx_j = (r0_j - sum_{i<j} W[j,i] dx_i) * invd_j + noise_j, j < T.
    W (T, T) = LHS diagonal block; padding sites carry invd = noise = 0.
    Same two-loop structure as `_draws_kernel`."""
    S = MICRO
    idx_s = jax.lax.broadcasted_iota(jnp.int32, (S,), 0)
    embed_r = jax.lax.broadcasted_iota(jnp.int32, (T, S), 0)
    embed_c = jax.lax.broadcasted_iota(jnp.int32, (T, S), 1)

    def micro(i, dx_all):
        j0 = pl.multiple_of(i * S, S)
        corr = jnp.sum(W_ref[pl.ds(j0, S), :] * dx_all[None, :], axis=1)
        base = r_ref[pl.ds(j0, S)] - corr                        # (S,)

        def draw(t, dx_mb):
            j = j0 + t
            sel = idx_s == t
            rhs = (jnp.sum(jnp.where(sel, base, 0.0))
                   - jnp.sum(W_ref[j, pl.ds(j0, S)] * dx_mb))
            dxj = rhs * invd_ref[j] + noise_ref[j]
            return jnp.where(sel, dxj, dx_mb)

        dx_mb = jax.lax.fori_loop(0, S, draw, jnp.zeros((S,), F32))
        dx_ref[pl.ds(j0, S)] = dx_mb
        onehot = embed_r == j0 + embed_c
        return dx_all + jnp.sum(jnp.where(onehot, dx_mb[None, :], 0.0), axis=1)

    jax.lax.fori_loop(0, T // S, micro, jnp.zeros((T,), F32))


def mme_block_draws(W, r0, invd, noise):
    """One MME block's T sequential single-site Gaussian draw deltas.
    W (T, T) f32 LHS block; r0/invd/noise (T,).  Returns dx (T,)."""
    T = W.shape[0]
    interp = runtime.interpret()
    return pl.pallas_call(
        functools.partial(_mme_kernel, T),
        out_shape=jax.ShapeDtypeStruct((T,), F32),
        backend="triton",
        interpret=interp,
        compiler_params=(None if interp else pl_triton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1)),
        name="mme_block_draws",
    )(W.astype(F32), r0.astype(F32), invd.astype(F32), noise.astype(F32))


def supports_mme_block(T: int, dtype) -> bool:
    return dtype == F32 and T >= MICRO and T & (T - 1) == 0
