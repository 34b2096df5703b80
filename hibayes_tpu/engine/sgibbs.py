"""Summary-level MCMC engine (SBayes) over LD matrices.

A redesign of the reference's dense- and sparse-LD samplers
(reference: src/SBayesD.cpp:5-609, src/SBayesS.cpp:21-679).  The chain state
is ``r_hat`` — the adjusted X'y vector — and each SNP draw is followed by a
rank-1 update ``r_hat += (g_old - g_new) * n * LD[:, i]`` (SBayesD.cpp:264-267).

Blocked formulation (exactly equivalent, built on matrix products):

    per block b of B SNPs within an LD segment:
        r_local = r_hat[block]              # the block slice IS the dot state
        scan j:  rhs = r_local[j] + xpx_j g_j ; draw ; r_local += dg n W_b[:, j]
        r_hat  += n * LD[:, block] @ dg_b   # one (m_c x B) matmul

where W_b = n * LD[block, block].  LD lives as per-chromosome dense segments
(the reference's block-sparse chromosome layout, tXXmat.cpp:504-605, becomes
a tuple of dense device tensors) — the dense genome-wide case is a single
segment.  SBayesS semantics are carried by ``varediff`` (per-SNP residual
inflation for truncated LD, SBayesS.cpp:131-141) and the rejection guard.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .gibbs import (
    HIGHEST,
    STREAM_SNP_CHI,
    STREAM_SNP_U,
    STREAM_SNP_Z,
    STREAM_SNP_Z2,
    STREAM_VE,
    GibbsSpec,
    Priors,
    _kernel_draws,
    _snp_scan_step,
    alphabet_global_updates,
    pad_to_block,
)


class SChainState(NamedTuple):
    it: jnp.ndarray
    r_hat: jnp.ndarray       # (m_pad,)
    g: jnp.ndarray           # (m_pad,)
    varg: jnp.ndarray
    vargL: jnp.ndarray
    lambda2: jnp.ndarray
    pi: jnp.ndarray
    vara_fold: jnp.ndarray
    vara: jnp.ndarray
    vare: jnp.ndarray
    track: jnp.ndarray
    nzrate: jnp.ndarray
    wppa: jnp.ndarray


class SGibbsData(NamedTuple):
    ld_segs: tuple           # per segment (mc_pad, mc_pad), covariance scale
    xy: jnp.ndarray          # (m_pad,)
    xpx: jnp.ndarray         # (m_pad,) = diag(LD)*n
    vx: jnp.ndarray          # (m_pad,) = diag(LD), 0 for masked/padded SNPs
    real: jnp.ndarray        # (m_pad,) bool: real AND estimable SNPs
    varediff: jnp.ndarray    # (m_pad,)
    fold: jnp.ndarray
    windindx0: jnp.ndarray
    yy: jnp.ndarray          # scalar
    # tiled-sparse LD (O(nnz) layout, data/sparse_ld.py); ld_segs is () then
    ld_tiles: jnp.ndarray | None = None   # (nbr, K_max, T, T)
    ld_cols: jnp.ndarray | None = None    # (nbr, K_max) int32
    ld_valid: jnp.ndarray | None = None   # (nbr, K_max) bool


def prepare_sgibbs_data(
    sumstat, ld, *, fold=None, windindx=None, nw=0, block=64, dtype=jnp.float32,
):
    """Initialise from COJO-style summary stats + an LD object.

    sumstat: (m, 4) array of [MAF, BETA, SE, N] (reference column selection
    R/sbayes.r:209-210).  Returns (data, n_eff, vary, nvar0, seg_sizes).
    Initialisation mirrors src/SBayesD.cpp:92-115.
    """
    ss = np.asarray(sumstat, dtype=np.float64)
    m = ss.shape[0]
    if ld.m != m:
        raise ValueError("Number of SNPs not equals.")
    ncol = ss[:, 3]
    n_eff = int(np.round(np.nanmean(ncol[np.isfinite(ncol)])))
    est = np.isfinite(ss[:, 1]) & np.isfinite(ss[:, 2]) & np.isfinite(ss[:, 3])
    nvar0 = int((~est).sum())

    diag = np.asarray(ld.diag, dtype=np.float64)
    xpx = diag * n_eff
    xy = np.where(est, xpx * ss[:, 1], 0.0)
    yyi = np.where(est, xpx * (ss[:, 1] ** 2 + (ss[:, 3] - 2.0) * ss[:, 2] ** 2), 0.0)
    count_y = int(est.sum())
    if count_y == 0:
        raise ValueError("Lack of SE.")
    yy = float(yyi.sum() / count_y)
    vary = yy / (n_eff - 1)

    nnz = np.asarray(ld.nnz_per_col(), dtype=np.float64)
    varediff = (m - nnz) / m

    # tiled-sparse LD: single contiguous layout padded to the tile grid;
    # the sweep walks block rows and touches only stored tiles (O(nnz))
    from ..data.sparse_ld import TiledSparseLD

    if isinstance(ld, TiledSparseLD):
        if block != ld.tile:
            raise ValueError(
                f"block ({block}) must equal the LD tile size ({ld.tile})"
            )
        m_pad = ld.m_pad
        pad = m_pad - m
        windindx = np.asarray(windindx) if windindx is not None else None
        data = SGibbsData(
            ld_segs=(),
            xy=jnp.asarray(np.pad(xy, (0, pad)), dtype),
            xpx=jnp.asarray(np.pad(xpx, (0, pad)), dtype),
            vx=jnp.asarray(np.pad(np.where(est, diag, 0.0), (0, pad)), dtype),
            real=jnp.asarray(np.pad(est, (0, pad))),
            varediff=jnp.asarray(np.pad(varediff, (0, pad)), dtype),
            fold=jnp.asarray(fold if fold is not None else np.zeros(2), dtype),
            windindx0=(
                jnp.asarray(np.pad(windindx - 1, (0, pad), constant_values=nw), jnp.int32)
                if windindx is not None
                else jnp.zeros((m_pad,), jnp.int32)
            ),
            yy=jnp.asarray(yy, dtype),
            ld_tiles=jnp.asarray(ld.tiles, dtype),
            ld_cols=jnp.asarray(ld.col_idx, jnp.int32),
            ld_valid=jnp.asarray(ld.valid),
        )
        return data, n_eff, vary, nvar0, (m_pad,), (m,)

    # segment layout: pad each chromosome block to a multiple of `block`
    from ..data.ld import BlockDiagLD

    if isinstance(ld, BlockDiagLD):
        raw_blocks = [np.asarray(b, dtype=np.float64) for b in ld.blocks]
    else:
        raw_blocks = [np.asarray(ld.values, dtype=np.float64)]
    seg_sizes = []
    seg_real = []
    segs = []
    off = 0
    xy_p, xpx_p, vx_p, real_p, vediff_p, wind_p = [], [], [], [], [], []
    windindx = np.asarray(windindx) if windindx is not None else None
    for b in raw_blocks:
        mc = b.shape[0]
        mc_pad = pad_to_block(mc, block)
        seg = np.zeros((mc_pad, mc_pad))
        seg[:mc, :mc] = b
        segs.append(jnp.asarray(seg, dtype))
        seg_sizes.append(mc_pad)
        seg_real.append(mc)
        sl = slice(off, off + mc)
        pad = mc_pad - mc
        xy_p.append(np.pad(xy[sl], (0, pad)))
        xpx_p.append(np.pad(xpx[sl], (0, pad)))
        vx_p.append(np.pad(np.where(est[sl], diag[sl], 0.0), (0, pad)))
        real_p.append(np.pad(est[sl], (0, pad)))
        vediff_p.append(np.pad(varediff[sl], (0, pad)))
        if windindx is not None:
            wind_p.append(np.pad(windindx[sl] - 1, (0, pad), constant_values=nw))
        off += mc
    m_pad = sum(seg_sizes)
    data = SGibbsData(
        ld_segs=tuple(segs),
        xy=jnp.asarray(np.concatenate(xy_p), dtype),
        xpx=jnp.asarray(np.concatenate(xpx_p), dtype),
        vx=jnp.asarray(np.concatenate(vx_p), dtype),
        real=jnp.asarray(np.concatenate(real_p)),
        varediff=jnp.asarray(np.concatenate(vediff_p), dtype),
        fold=jnp.asarray(fold if fold is not None else np.zeros(2), dtype),
        windindx0=(
            jnp.asarray(np.concatenate(wind_p), jnp.int32)
            if windindx is not None
            else jnp.zeros((m_pad,), jnp.int32)
        ),
        yy=jnp.asarray(yy, dtype),
    )
    return data, n_eff, vary, nvar0, tuple(seg_sizes), tuple(seg_real)


def _iteration_randoms(spec: GibbsSpec, key, dt):
    """Per-SNP randoms of one iteration (same stream policy as
    gibbs._pre_sweep: unused streams are skipped without changing the
    consumed ones)."""
    mi = spec.model_index
    m_pad = spec.m_pad
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
            jnp.asarray((spec.dfvara + 1.0) / 2.0, dt), (m_pad,), dtype=dt,
        )
    else:
        chi_snp = jnp.ones((m_pad,), dt)
    if mi == 5:
        z2_snp = jax.random.normal(jax.random.fold_in(key, STREAM_SNP_Z2), (m_pad,), dtype=dt)
    else:
        z2_snp = jnp.zeros((m_pad,), dt)
    return z_snp, u_snp, chi_snp, z2_snp


def _iteration_consts(spec: GibbsSpec, data: SGibbsData, key, state):
    dt = data.xy.dtype
    return {
        "varg": state.varg,
        "s2varg_df": jnp.asarray(spec.s2varg * spec.dfvara, dt),
        "logpi": jnp.log(state.pi),
        "lambda2": state.lambda2,
        "vara_fold": state.vara_fold,
        "fold": data.fold,
        "vary": jnp.asarray(spec.vary, dt),
        "reject_key": jax.random.fold_in(key, 99),
    }


def one_s_iteration(spec: GibbsSpec, data: SGibbsData, base_key,
                    state: SChainState, mesh=None):
    from ..ops import blockgibbs

    dt = data.xy.dtype
    B = spec.block
    m_pad = spec.m_pad
    n = spec.n
    key = jax.random.fold_in(base_key, state.it)
    z_snp, u_snp, chi_snp, z2_snp = _iteration_randoms(spec, key, dt)

    # per-SNP residual variance: varediff*vara + vare (SBayesS.cpp:285);
    # varediff == 0 for dense LD reduces this to vare (SBayesD semantics).
    vei = data.varediff * state.vara + state.vare
    consts = _iteration_consts(spec, data, key, state)

    r_hat = state.r_hat
    g = state.g
    vargL_full = state.vargL if state.vargL.size else jnp.zeros((m_pad,), dt)
    vargi_acc = jnp.zeros((), dt)
    vargR_acc = jnp.zeros((), dt)
    kernel = _kernel_draws(spec, dt)
    z_retry = (blockgibbs.retry_normals(key, m_pad)
               if kernel and blockgibbs.guard_on(spec) else None)

    if data.ld_tiles is not None:
        nbr = data.ld_tiles.shape[0]
        snp_s = int(mesh.shape.get("snp", 1)) if mesh is not None else 1
        sweep = (partial(_tiled_sweep_snp_sharded, mesh=mesh)
                 if snp_s > 1 and nbr % snp_s == 0 else _tiled_sweep)
        r_hat, g_new, track, vargL_new, vargi_acc, vargR_acc = sweep(
            spec, consts, data, vei, g, vargL_full,
            z_snp, u_snp, chi_snp, z2_snp, r_hat, z_retry=z_retry,
        )
        return _s_finish(
            spec, data, key, state, g_new, track,
            vargL_new if state.vargL.size else state.vargL,
            r_hat, vargi_acc, vargR_acc,
        )

    if kernel:
        return _one_s_iteration_kernel(
            spec, data, key, state, consts, vei, vargL_full,
            z_snp, u_snp, chi_snp, z2_snp, z_retry,
        )

    g_parts, track_parts, vargL_parts = [], [], []

    off = 0
    for seg_i, mc in enumerate(spec.seg_sizes):
        LDs = data.ld_segs[seg_i]
        nblocks = mc // B
        sl = lambda x: jax.lax.dynamic_slice(
            x, (off,) + (0,) * (x.ndim - 1), (mc,) + x.shape[1:])
        r_seg = sl(r_hat)

        def rsseg(x):
            return sl(x).reshape(nblocks, B, *x.shape[1:])

        def block_body(carry, xs):
            r_seg, vargi_acc, vargR_acc = carry
            (b, xpx_b, vx_b, vei_b, g_old_b, zb, ub, chib, z2b, vargLb, gidx_b) = xs
            Wb = n * jax.lax.dynamic_slice(LDs, (b * B, b * B), (B, B))
            r0 = jax.lax.dynamic_slice(r_seg, (b * B,), (B,))
            (r_fin, vargi_acc, vargR_acc), (g_new_b, track_b, vargL_new_b) = jax.lax.scan(
                partial(_snp_scan_step, spec, consts),
                (r0, vargi_acc, vargR_acc),
                (jnp.arange(B), gidx_b, Wb, xpx_b, vx_b, vei_b, g_old_b, zb, ub, chib, z2b, vargLb),
            )
            dg = g_old_b - g_new_b
            cols = jax.lax.dynamic_slice(LDs, (0, b * B), (mc, B))
            r_seg = r_seg + n * jnp.matmul(cols, dg, precision=HIGHEST)
            return (r_seg, vargi_acc, vargR_acc), (g_new_b, track_b, vargL_new_b)

        (r_seg, vargi_acc, vargR_acc), (g_new, track_new, vargL_new) = jax.lax.scan(
            block_body,
            (r_seg, vargi_acc, vargR_acc),
            (
                jnp.arange(nblocks),
                rsseg(data.xpx),
                rsseg(data.vx),
                rsseg(vei),
                rsseg(g),
                rsseg(z_snp),
                rsseg(u_snp),
                rsseg(chi_snp),
                rsseg(z2_snp),
                rsseg(vargL_full),
                rsseg(jnp.arange(m_pad)),
            ),
        )
        r_hat = jax.lax.dynamic_update_slice(r_hat, r_seg, (off,))
        g_parts.append(g_new.reshape(mc))
        track_parts.append(track_new.reshape(mc))
        vargL_parts.append(vargL_new.reshape(mc))
        off += mc

    g = jnp.concatenate(g_parts)
    track = jnp.concatenate(track_parts)
    vargL = jnp.concatenate(vargL_parts) if state.vargL.size else state.vargL

    varg, pi, vara_fold, lambda2 = alphabet_global_updates(
        spec, key, g, track, data.real, data.fold,
        vargi_acc, vargR_acc, vargL,
        state.varg, state.pi, state.vara_fold, state.lambda2,
    )

    # Vg/Ve draws from quadratic forms in r_hat (src/SBayesD.cpp:458-468)
    kvara = jax.random.fold_in(key, 31)
    chi_a = 2.0 * jax.random.gamma(kvara, jnp.asarray((n + spec.dfvara) / 2.0, dt), dtype=dt)
    vara = (jnp.dot(g, data.xy - r_hat, precision=HIGHEST) + spec.s2vara * spec.dfvara) / chi_a
    kve = jax.random.fold_in(key, STREAM_VE)
    chi_e = 2.0 * jax.random.gamma(kve, jnp.asarray((n + spec.dfvare) / 2.0, dt), dtype=dt)
    vare = (data.yy - jnp.dot(g, data.xy + r_hat, precision=HIGHEST)
            + spec.s2vare * spec.dfvare) / chi_e
    vare = jnp.where(vare < 0, 0.5 * vara, vare)  # negative-Ve guard (SBayesD.cpp:468)

    post = state.it >= spec.nburn
    nz = (track > 0) & data.real
    nzrate = state.nzrate + jnp.where(post, nz.astype(dt), 0.0)
    wppa = state.wppa
    if spec.nw:
        win_any = jax.ops.segment_max(
            nz.astype(jnp.int32), data.windindx0, num_segments=spec.nw + 1
        )[: spec.nw]
        wppa = wppa + jnp.where(post, win_any.astype(dt), 0.0)

    return SChainState(
        it=state.it + 1, r_hat=r_hat, g=g, varg=varg, vargL=vargL,
        lambda2=lambda2, pi=pi, vara_fold=vara_fold, vara=vara, vare=vare,
        track=track, nzrate=nzrate, wppa=wppa,
    )


def _tiled_sweep_rows(spec: GibbsSpec, consts, dt, tiles, cols, valid,
                      pv_rows, row_ids, r_hat, z_retry=None):
    """Blocked Gibbs over an arbitrary set of LD block rows (global indices
    ``row_ids``) against the FULL r_hat: block row i draws against its
    diagonal tile W_b = n*LD[block,block], then the rank-1 r_hat update
    touches ONLY stored tiles, r_hat[rows of tile (i,j)] += n*tile^T @ dg —
    O(nnz) work, the reference's CSC column-iterator semantics
    (src/SBayesS.cpp:292-296).  The row subset makes this the shard-local
    body of the SNP-sharded summary sweep.

    The B draws of a row run in the Pallas draws kernel when the spec asks
    for it (rejection-guard retries from `z_retry`, (N_RETRY, rows*B)),
    else in the per-SNP XLA scan."""
    from ..ops import blockgibbs

    B = spec.block
    n = spec.n
    nbg, k_max = tiles.shape[0], tiles.shape[1]
    kernel = _kernel_draws(spec, dt)
    flat = lambda x: x.reshape(-1, *x.shape[2:])
    P_rows = None
    if kernel:
        xpx, vx, vei, g, z, u, chi, z2, vargL, _ = (flat(a) for a in pv_rows)
        P = blockgibbs.pack_draw_rows(
            spec, dict(consts, vargL_vec=vargL), xpx, vx, vei, g, z, u, chi,
            z_retry)
        P_rows = blockgibbs.to_block_layout(P[None], nbg, B)

    def block_body(carry, xs):
        r_hat, vargi_acc, vargR_acc = carry
        (i, (xpx_b, vx_b, vei_b, g_old_b, zb, ub, chib, z2b, vargLb, gidx_b),
         P_b, tiles_i, cols_i, valid_i) = xs
        Wb = n * tiles_i[0]  # diagonal tile is stored first
        r0 = jax.lax.dynamic_slice(r_hat, (i * B,), (B,))
        if kernel:
            dg, track_b = blockgibbs.block_draws(spec, P_b, Wb, r0[:, None])
            dg = dg[:, 0]
            g_new_b, track_b, vargL_new_b = g_old_b - dg, track_b[:, 0], vargLb
        else:
            (_, vargi_acc, vargR_acc), (g_new_b, track_b, vargL_new_b) = (
                jax.lax.scan(
                    partial(_snp_scan_step, spec, consts),
                    (r0, vargi_acc, vargR_acc),
                    (jnp.arange(B), gidx_b, Wb, xpx_b, vx_b, vei_b,
                     g_old_b, zb, ub, chib, z2b, vargLb),
                ))
            dg = g_old_b - g_new_b

        def tile_upd(r_acc, k):
            j = cols_i[k]
            upd = jnp.where(
                valid_i[k],
                n * jnp.matmul(tiles_i[k].T, dg, precision=HIGHEST),
                jnp.zeros((B,), dt),
            )
            seg = jax.lax.dynamic_slice(r_acc, (j * B,), (B,)) + upd
            return jax.lax.dynamic_update_slice(r_acc, seg, (j * B,)), None

        r_hat, _ = jax.lax.scan(tile_upd, r_hat, jnp.arange(k_max))
        return (r_hat, vargi_acc, vargR_acc), (g_new_b, track_b, vargL_new_b)

    (r_hat, vargi_acc, vargR_acc), (g_new, track, vargL_new) = jax.lax.scan(
        block_body,
        (r_hat, jnp.zeros((), dt), jnp.zeros((), dt)),
        (row_ids, pv_rows, P_rows, tiles, cols, valid),
    )
    g_new, track, vargL_new = (a.reshape(-1) for a in (g_new, track, vargL_new))
    if kernel:
        # order-independent accumulators and BayesL local variances (they
        # feed only the next sweep): phase C after the kernel's draws
        one = lambda x: jnp.asarray(x)[None]
        _, vx_l, vei_l, _, _, u_l, _, z2_l, _, _ = (flat(a) for a in pv_rows)
        (_, _, vargL_new, _, _, vi, vR) = blockgibbs._phase_c_mc(
            spec, jax.tree_util.tree_map(one, consts), vx_l, one(vei_l),
            one(g_new), one(track.astype(jnp.int32)), one(u_l), one(z2_l),
            one(vargL_new), None, None)
        vargL_new, vargi_acc, vargR_acc = vargL_new[0], vi[0], vR[0]
    return (r_hat, g_new, track.astype(jnp.int32), vargL_new, vargi_acc,
            vargR_acc)


def _tiled_sweep(spec: GibbsSpec, consts, data: SGibbsData, vei, g, vargL_full,
                 z_snp, u_snp, chi_snp, z2_snp, r_hat, z_retry=None):
    """Single-device tiled sweep: all block rows in order."""
    dt = data.xy.dtype
    B = spec.block
    m_pad = spec.m_pad
    nbr = m_pad // B
    rs = lambda x: x.reshape(nbr, B, *x.shape[1:])
    pv_rows = (rs(data.xpx), rs(data.vx), rs(vei), rs(g), rs(z_snp),
               rs(u_snp), rs(chi_snp), rs(z2_snp), rs(vargL_full),
               rs(jnp.arange(m_pad)))
    return _tiled_sweep_rows(
        spec, consts, dt, data.ld_tiles, data.ld_cols, data.ld_valid,
        pv_rows, jnp.arange(nbr), r_hat, z_retry,
    )


def _tiled_sweep_snp_sharded(spec: GibbsSpec, consts, data: SGibbsData, vei,
                             g, vargL_full, z_snp, u_snp, chi_snp, z2_snp,
                             r_hat, z_retry=None, *, mesh):
    """SNP-sharded tiled summary sweep: each device's memory holds only its
    own LD tile rows; shards sweep in global block order (turn loop;
    inactive shards skip via lax.cond) and the r_hat deltas merge with one
    psum over the `snp` axis per turn — the same Markov kernel as the
    single-device sweep, scaling m beyond one device's memory.  The
    shard-local sweep is `_tiled_sweep_rows` (draws kernel or XLA scan), so
    the guard's retry normals are the single-device stream sliced per shard.
    Reference hot loop: src/SBayesS.cpp:292-296."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as PS

    dt = data.xy.dtype
    B = spec.block
    m_pad = spec.m_pad
    nbr = m_pad // B
    S = int(mesh.shape["snp"])
    nb_loc = nbr // S
    rs = lambda x: x.reshape(nbr, B, *x.shape[1:])
    pv = (rs(data.xpx), rs(data.vx), rs(vei), rs(g), rs(z_snp), rs(u_snp),
          rs(chi_snp), rs(z2_snp), rs(vargL_full), rs(jnp.arange(m_pad)))
    zr = (jnp.zeros((1, nbr, B), dt) if z_retry is None
          else z_retry.reshape(z_retry.shape[0], nbr, B))
    guard_rows = z_retry is not None

    if spec.shard_schedule == "pipeline":
        raise ValueError(
            "shard_schedule='pipeline' is an individual-level (ibrm) "
            "schedule; the summary engine supports 'turn' (exact) and "
            "'concurrent' (near-exact here: cross-shard coupling is "
            "bounded by LD tiles spanning shard boundaries)"
        )

    def body(tiles, cols, valid, pvt, zr, r_hat, consts):
        sidx = jax.lax.axis_index("snp")
        row_base = sidx * nb_loc
        g_b, vargL_b = pvt[3], pvt[8]

        def sweep_rows(rh, tiles_g, cols_g, valid_g, pvt_g, zr_g, base_g):
            """Sweep a group of local tile rows against the full r_hat."""
            nbg = tiles_g.shape[0]
            zr_flat = zr_g.reshape(zr_g.shape[0], -1) if guard_rows else None
            rh, gn, tr, vl, vi, vR = _tiled_sweep_rows(
                spec, consts, dt, tiles_g, cols_g, valid_g, pvt_g,
                base_g + jnp.arange(nbg), rh, zr_flat)
            return (rh, gn.reshape(nbg, B), tr.reshape(nbg, B),
                    vl.reshape(nbg, B), vi, vR)

        if spec.shard_schedule == "concurrent":
            # all shards sweep their local tile rows simultaneously against
            # the round-start r_hat; one psum merge per round (r_hat is
            # linear in g, so the delta merge is exact for the final state)
            Rm = spec.merge_rounds
            if nb_loc % Rm:
                raise ValueError(
                    f"merge_rounds ({Rm}) must divide the {nb_loc} local "
                    "LD tile rows")
            nb_g = nb_loc // Rm
            if Rm == 1:
                # single merge round: no scan, no per-round tile-slice copy
                rh2, g_new, track, vargL_new, vi, vR = sweep_rows(
                    r_hat, tiles, cols, valid, pvt, zr, row_base)
                r_hat = r_hat + jax.lax.psum(rh2 - r_hat, "snp")
            else:
                grp = lambda x: x.reshape(Rm, nb_g, *x.shape[1:])
                grpz = lambda x: x.reshape(
                    x.shape[0], Rm, nb_g, *x.shape[2:]).swapaxes(0, 1)
                xs = (grp(tiles), grp(cols), grp(valid),
                      tuple(grp(a) for a in pvt), grpz(zr),
                      jnp.arange(Rm) * nb_g)

                def round_body(carry, xs_r):
                    rh, vi_t, vR_t = carry
                    tiles_r, cols_r, valid_r, pvt_r, zr_r, off_r = xs_r
                    rh2, gn, tr, vl, vi, vR = sweep_rows(
                        rh, tiles_r, cols_r, valid_r, pvt_r, zr_r,
                        row_base + off_r)
                    rh = rh + jax.lax.psum(rh2 - rh, "snp")
                    return (rh, vi_t + vi, vR_t + vR), (gn, tr, vl)

                (r_hat, vi, vR), (gns, trs, vls) = jax.lax.scan(
                    round_body, (r_hat, jnp.zeros((), dt), jnp.zeros((), dt)), xs)
                g_new = gns.reshape(nb_loc, B)
                track = trs.reshape(nb_loc, B)
                vargL_new = vls.reshape(nb_loc, B)
        else:
            def local_sweep(rh):
                return sweep_rows(rh, tiles, cols, valid, pvt, zr, row_base)

            def skip(rh):
                return (rh, g_b, jnp.zeros((nb_loc, B), jnp.int32), vargL_b,
                        jnp.zeros((), dt), jnp.zeros((), dt))

            def turn(carry, s):
                r_hat, g_cur, tr_cur, vl_cur, vi_t, vR_t = carry
                act = sidx == s
                rh2, gn, tr, vl, vi, vR = jax.lax.cond(act, local_sweep, skip, r_hat)
                r_hat = r_hat + jax.lax.psum(rh2 - r_hat, "snp")
                g_cur = jnp.where(act, gn, g_cur)
                tr_cur = jnp.where(act, tr, tr_cur)
                vl_cur = jnp.where(act, vl, vl_cur)
                return (r_hat, g_cur, tr_cur, vl_cur, vi_t + vi, vR_t + vR), None

            init = (r_hat, g_b, jnp.zeros((nb_loc, B), jnp.int32), vargL_b,
                    jnp.zeros((), dt), jnp.zeros((), dt))
            (r_hat, g_new, track, vargL_new, vi, vR), _ = jax.lax.scan(
                turn, init, jnp.arange(S))
        return (g_new, track, vargL_new, r_hat,
                jax.lax.psum(vi, "snp"), jax.lax.psum(vR, "snp"))

    pv_spec = tuple(PS("snp", *([None] * (x.ndim - 1))) for x in pv)
    consts_spec = jax.tree_util.tree_map(lambda _: PS(), consts)
    g_new, track, vargL_new, r_hat, vargi, vargR = shard_map(
        body, mesh=mesh,
        in_specs=(PS("snp", None, None, None), PS("snp", None),
                  PS("snp", None), pv_spec, PS(None, "snp", None), PS(),
                  consts_spec),
        out_specs=(PS("snp", None), PS("snp", None), PS("snp", None),
                   PS(), PS(), PS()),
        check_vma=False,
    )(data.ld_tiles, data.ld_cols, data.ld_valid, pv, zr, r_hat, consts)
    return (r_hat, g_new.reshape(-1), track.reshape(-1),
            vargL_new.reshape(-1), vargi, vargR)


def _s_sweep_accums(spec: GibbsSpec, data: SGibbsData, state: SChainState,
                    vei, g, track, u_snp, z2_snp, vargL_full):
    """Order-independent post-sweep accumulators (equivalent to the scan's
    running sums): BayesC nonzero-effect variance sum, BayesR per-fold sum,
    BayesL per-SNP inverse-Gaussian local variances (they feed only the NEXT
    sweep, reference src/Bayes.cpp:718-742)."""
    dt = data.xy.dtype
    mi = spec.model_index
    if mi == 4:
        vargi_acc = jnp.sum(jnp.where(track == 1, g * g, 0.0))
    else:
        vargi_acc = jnp.zeros((), dt)
    if mi == 6:
        ffold = data.fold[track]
        vargR_acc = jnp.sum(
            jnp.where(track > 0, g * g / jnp.maximum(ffold, 1e-30), 0.0)
        )
    else:
        vargR_acc = jnp.zeros((), dt)
    if mi == 5 and state.vargL.size:
        lam2 = state.lambda2
        lam = jnp.sqrt(lam2)
        mu_ig = jnp.sqrt(vei) * lam / jnp.maximum(jnp.abs(g), 1e-30)
        y2 = z2_snp * z2_snp
        xig = mu_ig + 0.5 * mu_ig * mu_ig * y2 / lam2 - 0.5 * (mu_ig / lam2) * jnp.sqrt(
            4.0 * mu_ig * lam2 * y2 + mu_ig * mu_ig * y2 * y2
        )
        ig = jnp.where(u_snp <= mu_ig / (mu_ig + xig), xig, mu_ig * mu_ig / xig)
        vargi = 1.0 / ig
        ok = (vargi > 0) if spec.vargl_strict_pos else (vargi >= 0)
        vargL = jnp.where((data.vx > 0) & ok, vargi, vargL_full)
    else:
        vargL = state.vargL
    return vargi_acc, vargR_acc, vargL


def _s_finish(spec: GibbsSpec, data: SGibbsData, key, state: SChainState,
              g, track, vargL, r_hat, vargi_acc, vargR_acc) -> SChainState:
    """Post-sweep global updates shared by all summary sweep variants:
    mixture/variance hyper-updates, Vg/Ve quadratic-form draws with the
    negative-Ve guard (SBayesD.cpp:458-468), PIP/WPPA counters."""
    dt = data.xy.dtype
    n = spec.n

    varg, pi, vara_fold, lambda2 = alphabet_global_updates(
        spec, key, g, track, data.real, data.fold,
        vargi_acc, vargR_acc, vargL if state.vargL.size else jnp.zeros_like(g),
        state.varg, state.pi, state.vara_fold, state.lambda2,
    )
    kvara = jax.random.fold_in(key, 31)
    chi_a = 2.0 * jax.random.gamma(kvara, jnp.asarray((n + spec.dfvara) / 2.0, dt), dtype=dt)
    vara = (jnp.dot(g, data.xy - r_hat, precision=HIGHEST) + spec.s2vara * spec.dfvara) / chi_a
    kve = jax.random.fold_in(key, STREAM_VE)
    chi_e = 2.0 * jax.random.gamma(kve, jnp.asarray((n + spec.dfvare) / 2.0, dt), dtype=dt)
    vare = (data.yy - jnp.dot(g, data.xy + r_hat, precision=HIGHEST)
            + spec.s2vare * spec.dfvare) / chi_e
    vare = jnp.where(vare < 0, 0.5 * vara, vare)

    post = state.it >= spec.nburn
    nz = (track > 0) & data.real
    nzrate = state.nzrate + jnp.where(post, nz.astype(dt), 0.0)
    wppa = state.wppa
    if spec.nw:
        win_any = jax.ops.segment_max(
            nz.astype(jnp.int32), data.windindx0, num_segments=spec.nw + 1
        )[: spec.nw]
        wppa = wppa + jnp.where(post, win_any.astype(dt), 0.0)

    return SChainState(
        it=state.it + 1, r_hat=r_hat, g=g, varg=varg,
        vargL=vargL if state.vargL.size else state.vargL,
        lambda2=lambda2, pi=pi, vara_fold=vara_fold, vara=vara, vare=vare,
        track=track, nzrate=nzrate, wppa=wppa,
    )


def one_s_iteration_batch(spec: GibbsSpec, data: SGibbsData, chain_keys, states):
    """One iteration of K summary chains: the segment sweep runs every
    chain's draws in the per-block kernel (chains tiled across programs);
    RNG and global updates vmap.  Tiled LD and configurations the kernel
    does not cover run the single-chain iteration vmapped over chains."""
    from ..ops import blockgibbs

    dt = data.xy.dtype
    B = spec.block
    m_pad = spec.m_pad
    K = int(states.it.shape[0])

    if data.ld_tiles is not None or not _kernel_draws(spec, dt):
        # vmapped single-chain iteration on the XLA scan (nothing pallas
        # gets vmapped)
        spec_x = (
            spec if not spec.use_pallas
            else GibbsSpec(**{**spec.__dict__, "use_pallas": False})
        )
        return jax.vmap(
            lambda ck, st: one_s_iteration(spec_x, data, ck, st)
        )(chain_keys, states)

    keys = jax.vmap(lambda k, it: jax.random.fold_in(k, it))(chain_keys, states.it)

    def pre_one(key, state):
        rnd = _iteration_randoms(spec, key, dt)
        vei = data.varediff * state.vara + state.vare
        consts = _iteration_consts(spec, data, key, state)
        vargL_full = state.vargL if state.vargL.size else jnp.zeros((m_pad,), dt)
        c = dict(consts, vargL_vec=vargL_full)
        z_retry = (blockgibbs.retry_normals(key, m_pad)
                   if blockgibbs.guard_on(spec) else None)
        z, u, chi, _ = rnd
        P = blockgibbs.pack_draw_rows(
            spec, c, data.xpx, data.vx, vei, state.g, z, u, chi, z_retry)
        return consts, vei, vargL_full, rnd, P

    consts_b, vei_b, vargL_b, rnd_b, P = jax.vmap(pre_one)(keys, states)
    z_b, u_b, chi_b, z2_b = rnd_b
    R = P.shape[1]  # (K, R, m_pad)

    r_hat_b = states.r_hat  # (K, m_pad)
    dg_parts, track_parts = [], []
    off = 0
    for seg_i, mc in enumerate(spec.seg_sizes):
        P_seg = jax.lax.dynamic_slice(P, (0, 0, off), (K, R, mc))
        P_blocks = blockgibbs.to_block_layout(P_seg, mc // B, B)
        r_seg = jax.lax.dynamic_slice(r_hat_b, (0, off), (K, mc))
        dg_seg, track_seg, r_new = blockgibbs.sweep_s_segment_t(
            spec, data.ld_segs[seg_i], r_seg, P_blocks, spec.n)
        r_hat_b = jax.lax.dynamic_update_slice(
            r_hat_b, r_new.astype(dt), (0, off)
        )
        dg_parts.append(dg_seg)
        track_parts.append(track_seg)
        off += mc

    dg = jnp.concatenate(dg_parts, axis=1).astype(dt)   # (K, m_pad)
    track = jnp.concatenate(track_parts, axis=1)
    g_b = states.g - dg

    (g_b, track, vargL_new, _, _, vargi_acc, vargR_acc) = blockgibbs._phase_c_mc(
        spec, consts_b, data.vx, vei_b, g_b, track, u_b, z2_b, vargL_b,
        None, None,
    )

    return jax.vmap(
        lambda k, s, g, t, vl, rh, vi, vr: _s_finish(spec, data, k, s, g, t, vl, rh, vi, vr)
    )(keys, states, g_b, track, vargL_new, r_hat_b, vargi_acc, vargR_acc)


@partial(jax.jit, static_argnums=(0,))
def _run_all_s_multi(spec: GibbsSpec, data: SGibbsData, chain_keys, states):
    step = lambda ss: one_s_iteration_batch(spec, data, chain_keys, ss)
    states = jax.lax.fori_loop(0, spec.nburn, lambda i, ss: step(ss), states)

    def record_body(ss, _):
        ss = jax.lax.fori_loop(0, spec.thin, lambda i, s2: step(s2), ss)
        return ss, jax.vmap(lambda s1: _s_snapshot(spec, s1))(ss)

    states, samples = jax.lax.scan(record_body, states, None, length=spec.n_records)
    samples = jax.tree_util.tree_map(lambda x: jnp.swapaxes(x, 0, 1), samples)
    return states, samples


@partial(jax.jit, static_argnums=(0, 1))
def _run_s_burn_segment_multi(spec: GibbsSpec, k: int, data: SGibbsData,
                              chain_keys, states):
    step = lambda ss: one_s_iteration_batch(spec, data, chain_keys, ss)
    return jax.lax.fori_loop(0, k, lambda i, ss: step(ss), states)


@partial(jax.jit, static_argnums=(0, 1))
def _run_s_record_segment_multi(spec: GibbsSpec, k: int, data: SGibbsData,
                                chain_keys, states):
    step = lambda ss: one_s_iteration_batch(spec, data, chain_keys, ss)

    def record_body(ss, _):
        ss = jax.lax.fori_loop(0, spec.thin, lambda i, s2: step(s2), ss)
        return ss, jax.vmap(lambda s1: _s_snapshot(spec, s1))(ss)

    # records-major (k, K, ...); the caller swaps axes at the end
    return jax.lax.scan(record_body, states, None, length=k)


def run_s_chains(spec: GibbsSpec, data: SGibbsData, priors: Priors, pi_init,
                 seed=666666, nchains=4, checkpoint_path=None, progress=False,
                 chunk_records=0):
    """K independent summary chains with split-R-hat diagnostics; the
    segment sweep runs every chain's draws in the per-block kernel (the
    reference runs a single chain only).  With
    `checkpoint_path`/`progress`, execution is chunked and a killed run
    resumes bit-identically (same machinery as the individual engine)."""
    from .gibbs import _run_segmented
    from .gibbs import rhat_diagnostics as G_rhat_diagnostics

    base = jax.random.PRNGKey(seed)
    chain_keys = jax.random.split(base, nchains)
    state0 = init_s_state(spec, data, priors, pi_init)
    states0 = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (nchains,) + x.shape), state0
    )
    segmented = checkpoint_path is not None or progress
    if segmented:
        if chunk_records <= 0:
            chunk_records = max(spec.n_records // 10, 1)
        states, samples = _run_segmented(
            spec, data, None, states0, checkpoint_path, chunk_records,
            progress,
            burn_fn=lambda sp, k, d, key, st: _run_s_burn_segment_multi(
                sp, k, d, chain_keys, st),
            record_fn=lambda sp, k, d, key, st: _run_s_record_segment_multi(
                sp, k, d, chain_keys, st),
        )
        states = jax.block_until_ready(states)
        samples = {k: np.swapaxes(np.asarray(v), 0, 1)
                   for k, v in samples.items()}
    else:
        states, samples = _run_all_s_multi(spec, data, chain_keys, states0)
        states, samples = jax.block_until_ready((states, samples))

    nzct = spec.n_records * spec.thin
    pip = states.nzrate / nzct
    pip = jnp.where(pip >= 1.0, (nzct - 1.0) / nzct, pip)
    if spec.model_index in (1, 2, 5):
        pip = jnp.ones_like(pip)
    wppa = states.wppa / nzct
    wppa = jnp.where(wppa >= 1.0, (nzct - 1.0) / nzct, wppa)

    samples = dict(samples)
    real_cols = segment_unpad_index(spec)
    samples["alpha"] = np.asarray(samples["alpha"])[:, :, real_cols]
    extras = {
        "pip": np.asarray(pip.mean(axis=0))[real_cols],
        "wppa": np.asarray(wppa.mean(axis=0)),
        "nzct": nzct,
        "rhat": G_rhat_diagnostics(samples),
    }
    return states, samples, extras


def init_s_state(spec: GibbsSpec, data: SGibbsData, priors: Priors, pi_init) -> SChainState:
    dt = data.xy.dtype
    m_pad = spec.m_pad
    need_vargl = spec.model_index == 5
    return SChainState(
        it=jnp.zeros((), jnp.int32),
        r_hat=data.xy,  # r_hat initialised to xy (SBayesD.cpp:106)
        g=jnp.zeros((m_pad,), dt),
        varg=jnp.asarray(priors.varg, dt),
        vargL=jnp.full((m_pad,), priors.varg, dt) if need_vargl else jnp.zeros((0,), dt),
        lambda2=jnp.asarray(priors.lambda2, dt),
        pi=jnp.asarray(pi_init, dt),
        vara_fold=jnp.asarray(priors.varg, dt) * data.fold,
        vara=jnp.asarray(priors.vara, dt),
        vare=jnp.asarray(priors.vare, dt),
        track=jnp.zeros((m_pad,), jnp.int32),
        nzrate=jnp.zeros((m_pad,), dt),
        wppa=jnp.zeros((spec.nw,), dt),
    )


def _s_snapshot(spec, state):
    return {
        "pi": state.pi,
        "Vg": state.vara,
        "Ve": state.vare,
        "h2": state.vara / (state.vara + state.vare),
        "alpha": state.g,
        "lambda": jnp.sqrt(state.lambda2),
    }


@partial(jax.jit, static_argnums=(0, 4))
def _run_all_s(spec: GibbsSpec, data: SGibbsData, base_key, state: SChainState,
               mesh=None):
    step = lambda s: one_s_iteration(spec, data, base_key, s, mesh=mesh)
    state = jax.lax.fori_loop(0, spec.nburn, lambda i, s: step(s), state)

    def record_body(state, _):
        state = jax.lax.fori_loop(0, spec.thin, lambda i, s: step(s), state)
        return state, _s_snapshot(spec, state)

    state, samples = jax.lax.scan(record_body, state, None, length=spec.n_records)
    return state, samples


class _nullcontext:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


@partial(jax.jit, static_argnums=(0, 1, 5))
def _run_s_burn_segment_m(spec: GibbsSpec, k: int, data: SGibbsData, base_key,
                          state, mesh=None):
    step = lambda s: one_s_iteration(spec, data, base_key, s, mesh=mesh)
    return jax.lax.fori_loop(0, k, lambda i, s: step(s), state)


@partial(jax.jit, static_argnums=(0, 1, 5))
def _run_s_record_segment_m(spec: GibbsSpec, k: int, data: SGibbsData, base_key,
                            state, mesh=None):
    step = lambda s: one_s_iteration(spec, data, base_key, s, mesh=mesh)

    def record_body(state, _):
        state = jax.lax.fori_loop(0, spec.thin, lambda i, s: step(s), state)
        return state, _s_snapshot(spec, state)

    return jax.lax.scan(record_body, state, None, length=k)


def _run_s_burn_segment(spec, k, data, base_key, state):
    return _run_s_burn_segment_m(spec, k, data, base_key, state, None)


def _run_s_record_segment(spec, k, data, base_key, state):
    return _run_s_record_segment_m(spec, k, data, base_key, state, None)


def run_s_chain(spec: GibbsSpec, data: SGibbsData, priors: Priors, pi_init,
                seed=666666, checkpoint_path=None, chunk_records=0,
                progress=False, mesh=None):
    """Single summary chain; with `checkpoint_path`/`progress` the execution
    is chunked through the shared segmented runner (bit-identical resume —
    all randomness keys off state.it, engine/checkpoint.py).  With `mesh`
    (snp axis > 1) the tiled LD shards across devices and the sweep runs the
    exact turn-based shard schedule."""
    base_key = jax.random.PRNGKey(seed)
    state0 = init_s_state(spec, data, priors, pi_init)
    if mesh is not None:
        from ..parallel.mesh import shard_sgibbs_data

        data = shard_sgibbs_data(data, mesh)
    if checkpoint_path is not None or progress:
        from .gibbs import _run_segmented

        if chunk_records <= 0:
            chunk_records = max(spec.n_records // 10, 1)
        burn_fn = (lambda sp, k, d, key, st:
                   _run_s_burn_segment_m(sp, k, d, key, st, mesh))
        record_fn = (lambda sp, k, d, key, st:
                     _run_s_record_segment_m(sp, k, d, key, st, mesh))
        ctx = mesh if mesh is not None else _nullcontext()
        with ctx:
            state, samples = _run_segmented(
                spec, data, base_key, state0, checkpoint_path, chunk_records,
                progress, burn_fn=burn_fn, record_fn=record_fn,
            )
    else:
        ctx = mesh if mesh is not None else _nullcontext()
        with ctx:
            state, samples = _run_all_s(spec, data, base_key, state0, mesh)
    state, samples = jax.block_until_ready((state, samples))

    nzct = spec.n_records * spec.thin
    pip = state.nzrate / nzct
    pip = jnp.where(pip >= 1.0, (nzct - 1.0) / nzct, pip)
    if spec.model_index in (1, 2, 5):
        pip = jnp.ones_like(pip)
    wppa = state.wppa / nzct
    wppa = jnp.where(wppa >= 1.0, (nzct - 1.0) / nzct, wppa)

    samples = dict(samples)
    real_cols = segment_unpad_index(spec)
    samples["alpha"] = np.asarray(samples["alpha"])[:, real_cols]
    extras = {
        "pip": np.asarray(pip)[real_cols],
        "wppa": np.asarray(wppa),
        "nzct": nzct,
    }
    return state, samples, extras


def segment_unpad_index(spec: GibbsSpec):
    """Indices of real SNP positions within the segment-padded layout
    (each chromosome segment is zero-padded to a multiple of block)."""
    idx = []
    off = 0
    for mc_pad, mc_real in zip(spec.seg_sizes, spec.seg_real):
        idx.extend(range(off, off + mc_real))
        off += mc_pad
    return np.asarray(idx, dtype=np.int64)


def _one_s_iteration_kernel(spec, data, key, state, consts, vei, vargL_full,
                            z_snp, u_snp, chi_snp, z2_snp, z_retry):
    """Dense-segment summary sweep with the per-block draws in the Pallas
    kernel: per-SNP coefficients packed vectorised (phase A), one
    `sweep_s_segment_t` scan per LD segment as a single chain,
    order-independent accumulators afterwards."""
    from ..ops import blockgibbs

    dt = data.xy.dtype
    B = spec.block
    c = dict(consts)
    c["vargL_vec"] = vargL_full
    P = blockgibbs.pack_draw_rows(
        spec, c, data.xpx, data.vx, vei, state.g, z_snp, u_snp, chi_snp,
        z_retry)
    R = P.shape[0]

    r_hat = state.r_hat
    dg_parts, track_parts = [], []
    off = 0
    for seg_i, mc in enumerate(spec.seg_sizes):
        P_seg = jax.lax.dynamic_slice(P, (0, off), (R, mc))
        P_blocks = blockgibbs.to_block_layout(P_seg[None], mc // B, B)
        r_seg = jax.lax.dynamic_slice(r_hat, (off,), (mc,))
        dg_seg, track_seg, r_new = blockgibbs.sweep_s_segment_t(
            spec, data.ld_segs[seg_i], r_seg[None], P_blocks, spec.n)
        r_hat = jax.lax.dynamic_update_slice(r_hat, r_new[0].astype(dt), (off,))
        dg_parts.append(dg_seg[0])
        track_parts.append(track_seg[0])
        off += mc

    dg = jnp.concatenate(dg_parts).astype(dt)
    track = jnp.concatenate(track_parts)
    g = state.g - dg

    vargi_acc, vargR_acc, vargL = _s_sweep_accums(
        spec, data, state, vei, g, track, u_snp, z2_snp, vargL_full
    )
    return _s_finish(
        spec, data, key, state, g, track,
        vargL if state.vargL.size else state.vargL,
        r_hat, vargi_acc, vargR_acc,
    )
