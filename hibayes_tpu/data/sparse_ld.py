"""Tiled (block-sparse-row) LD storage with O(nnz) memory.

Device-side (JAX) replacement for the reference's sparse LD matrix
(`arma::sp_mat` CSC, reference: src/tXXmat.cpp:147-152 inserts only entries
with r^2*n > chisq; src/SBayesS.cpp:292-296 iterates stored columns).  A CSC
scalar layout is hostile to matrix units; instead the pruned matrix is stored
as fixed-size T x T tiles:

* only tiles containing at least one surviving entry are stored (entries
  inside a stored tile that fail the threshold are explicit zeros, so the
  sampled model is IDENTICAL to per-entry pruning);
* per block-row, tiles are kept in a padded (K_max) list with the DIAGONAL
  TILE FIRST — the blocked Gibbs sweep needs W_b = n * LD[block, block] at
  the start of every block step;
* the pattern is symmetric and both triangles are stored, so the rank-1
  r_hat update for block i touches exactly block-row i's tiles:
  r_hat[rows of tile (i,j)] += n * tile(i,j)^T @ dg.

Memory = n_tiles * T^2 * itemsize — O(nnz) for banded/LD-decay patterns,
vs O(m^2) for the dense layout.  Construction streams genotype column
stripes through the exact int8 Gram (`ldmat`-style), never materialising
the full m x m (reference analog: the out-of-core bigmemory pair loop,
src/tXXmat.cpp:101-184).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

HIGHEST = jax.lax.Precision.HIGHEST


@jax.jit
def _int_cross_gram(Xi, Xj):
    """Exact Xi'Xj (int8 path, int32 accumulate) + column sums."""
    S = jax.lax.dot_general(
        Xi, Xj, (((0,), (0,)), ((), ())), preferred_element_type=jnp.int32
    )
    si = jnp.sum(Xi.astype(jnp.int32), axis=0)
    sj = jnp.sum(Xj.astype(jnp.int32), axis=0)
    return S, si, sj


def _cross_cov(Xi, Xj) -> np.ndarray:
    """Covariance block cov(Xi, Xj) = (Xi'Xj - si sj'/n)/n as float64."""
    Xi = np.asarray(Xi)
    Xj = np.asarray(Xj)
    n = Xi.shape[0]
    if (
        np.issubdtype(Xi.dtype, np.integer)
        and Xi.dtype.itemsize == 1
        and np.issubdtype(Xj.dtype, np.integer)
        and Xj.dtype.itemsize == 1
    ):
        S, si, sj = jax.device_get(_int_cross_gram(jnp.asarray(Xi), jnp.asarray(Xj)))
        S = S.astype(np.float64)
        return (S - np.outer(si.astype(np.float64), sj.astype(np.float64)) / n) / n
    Xi = np.asarray(Xi, np.float64)
    Xj = np.asarray(Xj, np.float64)
    return (Xi - Xi.mean(0)).T @ (Xj - Xj.mean(0)) / n


@partial(jax.jit, static_argnums=(5, 6, 7, 8, 9))
def _device_tile_select(X_dev, sd_dev, chrom_dev, i0, j0,
                        n: int, SW: int, T: int, cap: int, chisq):
    """One stripe pair, ON DEVICE: slice the HBM-resident genotype, exact
    int8 cross-Gram -> covariance -> per-entry keep mask (chisq + chromosome
    + forced diagonal) -> per-tile any-reduction -> gather the surviving
    T x T tiles into a fixed-size buffer.  Only O(surviving tiles) bytes
    ever cross the host link (the genotype uploads once; stripe blocks never
    leave device memory).

    Returns (idx (cap,) flat tile index or -1, tiles (cap, T, T), count,
    keep_col_counts, keep_row_counts)."""
    Xi = jax.lax.dynamic_slice(X_dev, (0, i0), (X_dev.shape[0], SW))
    Xj = jax.lax.dynamic_slice(X_dev, (0, j0), (X_dev.shape[0], SW))
    sd_i = jax.lax.dynamic_slice(sd_dev, (i0,), (SW,))
    sd_j = jax.lax.dynamic_slice(sd_dev, (j0,), (SW,))
    chrom_i = jax.lax.dynamic_slice(chrom_dev, (i0,), (SW,))
    chrom_j = jax.lax.dynamic_slice(chrom_dev, (j0,), (SW,))
    S_ = jax.lax.dot_general(
        Xi, Xj, (((0,), (0,)), ((), ())), preferred_element_type=jnp.int32
    )
    # S is exact in f32 (entries <= 4n < 2^24); divide the row sums by n
    # BEFORE the outer product so the correction stays at O(1e-7) absolute
    si = jnp.sum(Xi.astype(jnp.int32), axis=0).astype(jnp.float32) / n
    sj = jnp.sum(Xj.astype(jnp.int32), axis=0).astype(jnp.float32)
    G = (S_.astype(jnp.float32) - jnp.outer(si, sj)) / n
    r = G / jnp.outer(sd_i, sd_j)
    if chisq is None:
        keep = jnp.ones_like(G, dtype=bool)
    else:
        keep = (r * r * n) > chisq
    keep = keep & (chrom_i[:, None] == chrom_j[None, :])
    keep = keep | ((i0 + jnp.arange(SW))[:, None] == (j0 + jnp.arange(SW))[None, :])
    nt = SW // T
    Gm = jnp.where(keep, G, 0.0)
    tb = keep.reshape(nt, T, nt, T).any(axis=(1, 3))
    count = jnp.sum(tb)
    idx = jnp.nonzero(tb.reshape(-1), size=cap, fill_value=-1)[0]
    G4 = Gm.reshape(nt, T, nt, T).transpose(0, 2, 1, 3).reshape(nt * nt, T, T)
    tiles = G4[jnp.where(idx >= 0, idx, 0)]
    return idx, tiles, count, keep.sum(axis=0), keep.sum(axis=1)


@dataclass
class TiledSparseLD:
    """Chi-square-pruned LD in block-sparse tiles (see module docstring).

    col_idx[i, 0] == i (diagonal tile first); invalid slots point at the own
    row with valid == False so gather/scatter stays in bounds.
    """

    tile: int
    m: int                 # real SNPs (m_pad = col_idx.shape[0] * tile)
    col_idx: np.ndarray    # (nbr, K_max) int32, block-column of each tile
    valid: np.ndarray      # (nbr, K_max) bool
    tiles: np.ndarray      # (nbr, K_max, T, T)
    nnz_col: np.ndarray    # (m,) surviving entries per column

    @property
    def nbr(self) -> int:
        return self.col_idx.shape[0]

    @property
    def k_max(self) -> int:
        return self.col_idx.shape[1]

    @property
    def m_pad(self) -> int:
        return self.nbr * self.tile

    @property
    def diag(self) -> np.ndarray:
        d = np.einsum("itt->it", self.tiles[:, 0]).reshape(-1)
        return d[: self.m]

    def nnz_per_col(self) -> np.ndarray:
        return self.nnz_col

    @property
    def n_tiles(self) -> int:
        return int(self.valid.sum())

    def nbytes(self) -> int:
        return self.tiles.nbytes + self.col_idx.nbytes + self.valid.nbytes

    def matvec(self, v) -> np.ndarray:
        """LD @ v with O(nnz) work (device-tiled).  Computes in the tile
        storage dtype (f64 needs the jax_enable_x64 flag)."""
        dt = jnp.float64 if (self.tiles.dtype == np.float64
                             and jax.config.jax_enable_x64) else jnp.float32
        vpad = np.zeros(self.m_pad, dtype=np.float64)
        vpad[: self.m] = np.asarray(v, np.float64)
        out = _tiled_matvec(
            jnp.asarray(self.tiles, dt),
            jnp.asarray(self.col_idx),
            jnp.asarray(self.valid),
            jnp.asarray(vpad, dt),
        )
        return np.asarray(out)[: self.m]

    def to_dense(self) -> np.ndarray:
        """Materialise (tests / small m only)."""
        T = self.tile
        G = np.zeros((self.m_pad, self.m_pad))
        for i in range(self.nbr):
            for k in range(self.k_max):
                if self.valid[i, k]:
                    j = int(self.col_idx[i, k])
                    G[i * T : (i + 1) * T, j * T : (j + 1) * T] = self.tiles[i, k]
        return G[: self.m, : self.m]

    @classmethod
    def from_dense(cls, G, tile=64, dtype=np.float64) -> "TiledSparseLD":
        """Pack an (already pruned) dense symmetric matrix into tiles."""
        G = np.asarray(G)
        m = G.shape[0]
        nbr = -(-m // tile)
        m_pad = nbr * tile
        Gp = np.zeros((m_pad, m_pad))
        Gp[:m, :m] = G
        nz = Gp.reshape(nbr, tile, nbr, tile).any(axis=(1, 3))
        nnz_col = (G != 0).sum(axis=0).astype(np.int64)
        return cls._assemble(Gp, nz, tile, m, nnz_col, dtype)

    @classmethod
    def _assemble(cls, Gp, nz, tile, m, nnz_col, dtype):
        nbr = nz.shape[0]
        np.fill_diagonal(nz, True)  # diagonal tile always stored
        k_max = int(nz.sum(axis=1).max())
        col_idx = np.tile(np.arange(nbr, dtype=np.int32)[:, None], (1, k_max))
        valid = np.zeros((nbr, k_max), dtype=bool)
        tiles = np.zeros((nbr, k_max, tile, tile), dtype=dtype)
        for i in range(nbr):
            js = np.flatnonzero(nz[i])
            js = np.concatenate([[i], js[js != i]])  # diagonal first
            col_idx[i, : len(js)] = js
            valid[i, : len(js)] = True
            for k, j in enumerate(js):
                tiles[i, k] = Gp[i * tile : (i + 1) * tile, j * tile : (j + 1) * tile]
        return cls(tile=tile, m=m, col_idx=col_idx, valid=valid, tiles=tiles,
                   nnz_col=nnz_col)

    @classmethod
    def from_scipy(cls, mat, tile=64, dtype=np.float64) -> "TiledSparseLD":
        import scipy.sparse as sp

        csr = sp.csr_matrix(mat)
        m = csr.shape[0]
        nbr = -(-m // tile)
        # tile-level pattern without densifying: block any-nonzero
        coo = csr.tocoo()
        nz = np.zeros((nbr, nbr), dtype=bool)
        nz[coo.row // tile, coo.col // tile] = True
        nnz_col = np.asarray((csr != 0).sum(axis=0)).ravel().astype(np.int64)
        np.fill_diagonal(nz, True)
        k_max = int(nz.sum(axis=1).max())
        col_idx = np.tile(np.arange(nbr, dtype=np.int32)[:, None], (1, k_max))
        valid = np.zeros((nbr, k_max), dtype=bool)
        tiles = np.zeros((nbr, k_max, tile, tile), dtype=dtype)
        m_pad = nbr * tile
        for i in range(nbr):
            js = np.flatnonzero(nz[i])
            js = np.concatenate([[i], js[js != i]])
            col_idx[i, : len(js)] = js
            valid[i, : len(js)] = True
            rows = csr[i * tile : min((i + 1) * tile, m)]
            for k, j in enumerate(js):
                blk = rows[:, j * tile : min((j + 1) * tile, m)].toarray()
                tiles[i, k, : blk.shape[0], : blk.shape[1]] = blk
        return cls(tile=tile, m=m, col_idx=col_idx, valid=valid, tiles=tiles,
                   nnz_col=nnz_col)


@jax.jit
def _tiled_matvec(tiles, col_idx, valid, v):
    nbr, k_max, T, _ = tiles.shape
    vb = v.reshape(nbr, T)

    def row(tiles_i, cols_i, valid_i):
        segs = vb[cols_i]                                  # (K, T)
        prods = jnp.einsum("kab,kb->ka", tiles_i, segs)    # (K, T)
        return jnp.sum(jnp.where(valid_i[:, None], prods, 0.0), axis=0)

    return jax.vmap(row)(tiles, col_idx, valid).reshape(-1)


def build_tiled_ld(
    geno,
    chisq=None,
    chrom=None,
    tile: int = 64,
    stripe: int = 4096,
    dtype=np.float32,
    progress: bool = False,
    gwas_geno=None,
    gwas_pos=None,
) -> TiledSparseLD:
    """Stream genotype column stripes through the device Gram and keep only LD
    tiles with surviving entries — never materialising the m x m matrix.

    keep rule (per entry): r^2 * n > chisq (reference src/tXXmat.cpp:147-152),
    diagonal always kept; with ``chrom`` given, entries crossing chromosomes
    are dropped (the reference's per-chromosome block layout, tXXmat_Chr,
    src/tXXmat.cpp:504-605 — here chromosome boundaries need not be
    tile-aligned).  chisq=None with chrom -> pure block-diagonal-by-chromosome.

    gwas_geno/gwas_pos overlay the GWAS sample's own LD for the SNPs present
    in both panels (reference tXXmat_Geno_gwas, src/tXXmat.cpp:314-502):
    gwas_pos maps the overlay panel's columns to reference-panel positions;
    patched entries obey the same chisq rule with the OVERLAY panel's n.

    Peak memory: one (stripe x stripe) float64 block + the O(nnz) tile store.
    """
    X = geno.values if hasattr(geno, "values") else np.asarray(geno)
    n, m = X.shape
    stripe = max(tile, (stripe // tile) * tile)
    nbr = -(-m // tile)
    m_pad = nbr * tile
    if chisq is None and chrom is None:
        raise ValueError("build_tiled_ld needs chisq and/or chrom (else use dense ldmat)")
    chrom_id = None
    if chrom is not None:
        chrom = np.asarray(chrom).astype(str)
        if chrom.shape[0] != m:
            raise ValueError("chrom must have one entry per SNP")
        _, chrom_id = np.unique(chrom, return_inverse=True)

    # pass 1: per-column sd for the r^2 threshold (cheap column stats)
    var = np.empty(m)
    for c0 in range(0, m, stripe):
        c1 = min(m, c0 + stripe)
        blk = np.asarray(X[:, c0:c1], np.float64)
        var[c0:c1] = blk.var(axis=0)
    sd = np.sqrt(np.maximum(var, 1e-30))

    # device fast path: int8 genotype + f32 tile store + no overlay panel
    # (the overlay patches individual entries host-side; f64 stores keep the
    # exact host path for the golden-equality tests)
    if (gwas_geno is None and np.dtype(dtype) == np.float32
            and np.issubdtype(np.asarray(X[:1, :1]).dtype, np.integer)
            and X.dtype.itemsize == 1):
        return _build_tiled_device(X, chisq, chrom_id, tile, stripe, sd,
                                   np.float32, progress)

    # overlay panel: map reference position -> overlay column
    ov_idx = None
    if gwas_geno is not None:
        if gwas_pos is None:
            raise ValueError("gwas_pos (reference positions of the overlay "
                             "panel's SNPs) is required with gwas_geno")
        Xg = gwas_geno.values if hasattr(gwas_geno, "values") else np.asarray(gwas_geno)
        gwas_pos = np.asarray(gwas_pos, dtype=np.int64)
        if gwas_pos.shape[0] != Xg.shape[1]:
            raise ValueError("gwas_pos must have one entry per overlay SNP")
        ng = Xg.shape[0]
        ov_idx = np.full(m, -1, dtype=np.int64)
        ov_idx[gwas_pos] = np.arange(len(gwas_pos))
        g_var = np.asarray(Xg, np.float64).var(axis=0)
        g_sd = np.sqrt(np.maximum(g_var, 1e-30))

    row_tiles = [dict() for _ in range(nbr)]
    nnz_col = np.zeros(m, dtype=np.int64)
    nstripes = -(-m // stripe)
    total_pairs = nstripes * (nstripes + 1) // 2
    done = 0

    def keep_mask(G, i0, i1, j0, j1):
        r2n = (G / np.outer(sd[i0:i1], sd[j0:j1])) ** 2 * n
        keep = np.ones_like(G, dtype=bool) if chisq is None else (r2n > chisq)
        if chrom_id is not None:
            keep &= chrom_id[i0:i1, None] == chrom_id[None, j0:j1]
        if i0 == j0:
            ii = np.arange(i1 - i0)
            keep[ii, ii] = True  # diagonal always kept
        return keep

    def harvest(Gm, keep, i0, j0):
        """Extract nonzero T x T tiles of a masked stripe block into the
        per-block-row stores, mirroring the transpose into the other row.
        Each global tile (gi, gj) with gj >= gi is visited by exactly one
        stripe pair; within a diagonal stripe pair (i0 == j0) only the upper
        tile triangle is taken (the lower is the same data transposed)."""
        si, sj = Gm.shape
        gi0, gj0 = i0 // tile, j0 // tile  # stripe % tile == 0 -> aligned
        Pi = -(-si // tile) * tile
        Pj = -(-sj // tile) * tile
        if (Pi, Pj) != Gm.shape:
            Gp = np.zeros((Pi, Pj), dtype=np.float64)
            Kp = np.zeros((Pi, Pj), dtype=bool)
            Gp[:si, :sj] = Gm
            Kp[:si, :sj] = keep
        else:
            Gp, Kp = Gm, keep
        tb = Kp.reshape(Pi // tile, tile, Pj // tile, tile).any(axis=(1, 3))
        for bi, bj in zip(*np.nonzero(tb)):
            gi, gj = gi0 + bi, gj0 + bj
            if gj < gi:
                continue  # diagonal stripe pair: lower tiles = upper^T
            t = Gp[bi * tile : (bi + 1) * tile, bj * tile : (bj + 1) * tile]
            row_tiles[gi][gj] = t.copy()
            if gi != gj:
                row_tiles[gj][gi] = t.T.copy()

    for a in range(nstripes):
        i0, i1 = a * stripe, min(m, (a + 1) * stripe)
        Xi = np.ascontiguousarray(X[:, i0:i1])
        for b in range(a, nstripes):
            j0, j1 = b * stripe, min(m, (b + 1) * stripe)
            Xj = Xi if b == a else np.ascontiguousarray(X[:, j0:j1])
            G = _cross_cov(Xi, Xj)
            keep = keep_mask(G, i0, i1, j0, j1)
            if ov_idx is not None:
                # REPLACE entries where both SNPs are in the overlay panel
                # with the panel's own covariance under the same keep rule
                # (reference tXXmat_Geno_gwas, src/tXXmat.cpp:388-416)
                mi_loc = np.flatnonzero(ov_idx[i0:i1] >= 0)
                mj_loc = np.flatnonzero(ov_idx[j0:j1] >= 0)
                if mi_loc.size and mj_loc.size:
                    ci = ov_idx[i0:i1][mi_loc]
                    cj = ov_idx[j0:j1][mj_loc]
                    Gg = _cross_cov(
                        np.ascontiguousarray(Xg[:, ci]),
                        np.ascontiguousarray(Xg[:, cj]),
                    )
                    if chisq is None:
                        keep_g = np.ones_like(Gg, dtype=bool)
                    else:
                        r2n_g = (Gg / np.outer(g_sd[ci], g_sd[cj])) ** 2 * ng
                        keep_g = r2n_g > chisq
                    if chrom_id is not None:
                        keep_g &= (chrom_id[i0 + mi_loc][:, None]
                                   == chrom_id[j0 + mj_loc][None, :])
                    keep_g |= (i0 + mi_loc)[:, None] == (j0 + mj_loc)[None, :]
                    G[np.ix_(mi_loc, mj_loc)] = Gg
                    keep[np.ix_(mi_loc, mj_loc)] = keep_g
            Gm = np.where(keep, G, 0.0)
            nnz_col[j0:j1] += keep.sum(axis=0)
            if b != a:
                nnz_col[i0:i1] += keep.sum(axis=1)
            harvest(Gm, keep, i0, j0)
            done += 1
            if progress:
                print(f"\rLD tiles: {100 * done // total_pairs}% "
                      f"({done}/{total_pairs} stripe pairs)", end="", flush=True)
    if progress:
        print()
    return _assemble_row_tiles(row_tiles, nbr, tile, m, nnz_col, dtype)


def _assemble_row_tiles(row_tiles, nbr, tile, m, nnz_col, dtype) -> TiledSparseLD:
    for i in range(nbr):
        row_tiles[i].setdefault(i, np.zeros((tile, tile)))
    k_max = max(len(d) for d in row_tiles)
    col_idx = np.tile(np.arange(nbr, dtype=np.int32)[:, None], (1, k_max))
    valid = np.zeros((nbr, k_max), dtype=bool)
    tiles = np.zeros((nbr, k_max, tile, tile), dtype=dtype)
    for i, d in enumerate(row_tiles):
        js = sorted(d.keys())
        js = [i] + [j for j in js if j != i]  # diagonal first
        col_idx[i, : len(js)] = js
        valid[i, : len(js)] = True
        for k, j in enumerate(js):
            tiles[i, k] = d[j]
    return TiledSparseLD(tile=tile, m=m, col_idx=col_idx, valid=valid,
                         tiles=tiles, nnz_col=nnz_col)


def _build_tiled_device(X, chisq, chrom_id, tile, stripe, sd, dtype,
                        progress) -> TiledSparseLD:
    """Device fast path of :func:`build_tiled_ld` (int8 genotype, f32 tiles):
    the genotype uploads ONCE to HBM; per stripe pair the covariance, keep
    mask and per-tile reduction all run on device, and only the surviving
    tiles (O(nnz)) cross the host link (`_device_tile_select`)."""
    n, m = X.shape
    SW = stripe
    ns = -(-m // SW)
    m_pad_s = ns * SW
    Xp = np.zeros((n, m_pad_s), np.int8)
    Xp[:, :m] = X
    sd_p = np.ones(m_pad_s, np.float32)
    sd_p[:m] = np.maximum(sd, 1e-15)
    ch = np.full(m_pad_s, -1, np.int32)
    ch[:m] = chrom_id.astype(np.int32) if chrom_id is not None else 0
    X_dev = jnp.asarray(Xp)
    sd_dev = jnp.asarray(sd_p)
    ch_dev = jnp.asarray(ch)

    nbr = -(-m // tile)
    nt = SW // tile
    cap = nt * nt  # full coverage: the fixed gather buffer can never overflow
    row_tiles = [dict() for _ in range(nbr)]
    nnz_col = np.zeros(m, dtype=np.int64)
    total = ns * (ns + 1) // 2
    done = 0
    for a in range(ns):
        i0 = a * SW
        for b in range(a, ns):
            j0 = b * SW
            idx_d, tiles_d, count_d, colc_d, rowc_d = _device_tile_select(
                X_dev, sd_dev, ch_dev, i0, j0, n, SW, tile, cap, chisq)
            k = int(count_d)
            jr = min(m, j0 + SW) - j0
            ir = min(m, i0 + SW) - i0
            nnz_col[j0 : j0 + jr] += np.asarray(colc_d[:jr], dtype=np.int64)
            if b != a:
                nnz_col[i0 : i0 + ir] += np.asarray(rowc_d[:ir], dtype=np.int64)
            if k:
                idx_np = np.asarray(idx_d[:k])
                sel = np.asarray(tiles_d[:k])  # only surviving tiles transfer
                for t in range(k):
                    bi, bj = divmod(int(idx_np[t]), nt)
                    gi = i0 // tile + bi
                    gj = j0 // tile + bj
                    if gi >= nbr or gj >= nbr:
                        continue  # stripe-padding tiles
                    if b == a and gj < gi:
                        continue  # lower triangle of the diagonal pair
                    tl = sel[t].astype(dtype)
                    row_tiles[gi][gj] = tl
                    if gi != gj:
                        row_tiles[gj][gi] = np.ascontiguousarray(tl.T)
            done += 1
            if progress:
                print(f"\rLD tiles: {100 * done // total}% "
                      f"({done}/{total} stripe pairs)", end="", flush=True)
    if progress:
        print()
    return _assemble_row_tiles(row_tiles, nbr, tile, m, nnz_col, dtype)
