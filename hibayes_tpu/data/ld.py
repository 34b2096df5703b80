"""LD (tXX) variance-covariance matrix construction on the device.

Device-side (JAX) replacement for the reference's O(m^2*n/2) OpenMP pair loops
(reference: src/tXXmat.cpp:101-840).  The covariance is one centered Gram
matrix — (X'X - n mu mu')/n — i.e. a single matmul instead of per-pair
dot products; the chi-square sparsity threshold (keep |r|^2*n > chisq,
tXXmat.cpp:147-152) becomes an elementwise mask.

Three layouts are produced, matching the reference's return types
(R/ldm.r:86-111) but redesigned for device residency:

* ``DenseLD``     — m x m dense (ldchr=True, chisq=None)
* ``SparseLD``    — chi-square-thresholded; stores the dense masked matrix
                    plus per-column nnz (for SBayesS's varediff) and a
                    scipy CSR export for interoperability
* ``BlockDiagLD`` — per-chromosome dense blocks (ldchr=False): the layout the
                    reference emulates with a block-sparse matrix
                    (tXXmat_Chr, tXXmat.cpp:504-605) and the natural sharded
                    layout for large m
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

HIGHEST = jax.lax.Precision.HIGHEST


def _cov_gram(X, dtype=jnp.float32):
    """(Xc' Xc) / n with Xc column-centered; single matmul."""
    X = jnp.asarray(X, dtype)
    n = X.shape[0]
    mu = jnp.mean(X, axis=0, keepdims=True)
    Xc = X - mu
    return jnp.matmul(Xc.T, Xc, precision=HIGHEST) / n


@jax.jit
def _int_gram(X):
    """Exact X'X and column sums for small-integer genotype codes via the
    int8 path (int8 x int8 -> int32 accumulation; entries <= 4n stay
    exact for n < 2^29).  Faster AND exact vs the f32 Gram."""
    S = jax.lax.dot_general(
        X, X, (((0,), (0,)), ((), ())), preferred_element_type=jnp.int32
    )
    s = jnp.sum(X.astype(jnp.int32), axis=0)
    return S, s


def _cov_dense_np(Xsub) -> np.ndarray:
    """Dense covariance block as float64 numpy; integer genotypes take the
    exact int8 path (the centering is a rank-1 correction applied in
    float64 on host, mirroring the mean-correction identity the reference
    uses in src/tXXmat.cpp:142-146)."""
    Xn = np.asarray(Xsub)
    nn = Xn.shape[0]
    if np.issubdtype(Xn.dtype, np.integer) and Xn.dtype.itemsize == 1:
        S, s = jax.device_get(_int_gram(jnp.asarray(Xn)))
        S = S.astype(np.float64)
        s = s.astype(np.float64)
        return (S - np.outer(s, s) / nn) / nn
    return np.asarray(jax.device_get(_cov_gram(Xsub)), dtype=np.float64)


def _chisq_mask(G, n, chisq):
    """Zero entries with r^2 * n <= chisq; keep the diagonal."""
    d = jnp.sqrt(jnp.maximum(jnp.diag(G), 1e-30))
    r = G / jnp.outer(d, d)
    keep = (r * r * n) > chisq
    keep = keep | jnp.eye(G.shape[0], dtype=bool)
    return jnp.where(keep, G, 0.0), keep


@dataclass
class DenseLD:
    values: np.ndarray  # (m, m)

    @property
    def m(self):
        return self.values.shape[0]

    @property
    def diag(self):
        return np.diag(self.values)

    def nnz_per_col(self):
        return np.full(self.m, self.m, dtype=np.int64)

    def matvec(self, v):
        return self.values @ v


@dataclass
class SparseLD:
    """Chi-square-pruned LD.  Dense storage with explicit zeros (device layout)
    plus the sparsity pattern; triggers SBayesS semantics in `sbrm`."""

    values: np.ndarray       # (m, m) with zeros outside the pattern
    nnz_col: np.ndarray      # (m,) nonzeros per column (for varediff)

    @property
    def m(self):
        return self.values.shape[0]

    @property
    def diag(self):
        return np.diag(self.values)

    def nnz_per_col(self):
        return self.nnz_col

    def matvec(self, v):
        return self.values @ v

    def to_csr(self):
        import scipy.sparse as sp

        return sp.csr_matrix(self.values)

    @classmethod
    def from_scipy(cls, mat):
        import scipy.sparse as sp

        csc = sp.csc_matrix(mat)
        nnz = np.diff(csc.indptr).astype(np.int64)
        return cls(values=np.asarray(csc.todense()), nnz_col=nnz)


@dataclass
class BlockDiagLD:
    """Per-chromosome dense blocks.  SNPs must be grouped contiguously by
    chromosome (the caller reorders; matches the reference's requirement that
    the map is per-chromosome sorted)."""

    blocks: list                    # list[np.ndarray] (m_c, m_c)
    sizes: list = field(default_factory=list)
    nnz_col: np.ndarray | None = None  # set when chi-square-pruned

    @property
    def m(self):
        return int(sum(self.sizes))

    @property
    def diag(self):
        return np.concatenate([np.diag(b) for b in self.blocks])

    def nnz_per_col(self):
        if self.nnz_col is not None:
            return self.nnz_col
        return np.concatenate(
            [np.full(s, s, dtype=np.int64) for s in self.sizes]
        )

    def matvec(self, v):
        out = np.empty_like(v)
        off = 0
        for b, s in zip(self.blocks, self.sizes):
            out[off : off + s] = b @ v[off : off + s]
            off += s
        return out


def ldmat(
    geno,
    map=None,
    gwas_geno=None,
    gwas_map=None,
    chisq=None,
    ldchr=False,
    dtype=jnp.float32,
    threads=0,  # accepted for reference-signature parity (R/ldm.r:38);
                # the Gram matmul is device-scheduled, not host-threaded
    tiled=False,
    tile=64,
    stripe=4096,
    progress=False,
):
    """LD matrix construction (reference API: R/ldm.r:31-112).

    geno: (n, m) genotype (GenoMatrix or array).  chisq=None -> dense;
    chisq>0 -> sparse threshold.  ldchr=False with a map -> per-chromosome
    blocks.  gwas_geno/gwas_map overlay the GWAS sample's own LD for SNPs
    present in both panels (tXXmat_*_gwas, tXXmat.cpp:314-502).

    tiled=True -> an O(nnz) `TiledSparseLD` built by streaming genotype
    column stripes through the device Gram (never materialising the m x m
    matrix; reference analog: the out-of-core bigmemory pair loop,
    src/tXXmat.cpp:101-184).  Requires chisq and/or a per-chromosome map;
    `stripe` bounds peak memory, `progress` prints the reference-style
    percent bar (tXXmat.cpp:10-41).
    """
    X = geno.values if hasattr(geno, "values") else np.asarray(geno)
    n, m = X.shape
    if chisq is not None and chisq < 0:
        chisq = None
    if tiled:
        from .sparse_ld import build_tiled_ld

        chrom_arg = None
        if map is not None and not ldchr:
            chrom_arg = np.asarray(
                map["Chr"] if isinstance(map, dict) else map[:, 1]
            ).astype(str)
        gwas_X = gwas_pos = None
        if gwas_geno is not None:
            if map is None or gwas_map is None:
                raise ValueError("map information for both panels should be provided.")
            ref_ids = np.asarray(
                map["SNP"] if isinstance(map, dict) else map[:, 0]
            ).astype(str)
            gw_ids = np.asarray(
                gwas_map["SNP"] if isinstance(gwas_map, dict) else gwas_map[:, 0]
            ).astype(str)
            Xg = gwas_geno.values if hasattr(gwas_geno, "values") else np.asarray(gwas_geno)
            shared = np.isin(gw_ids, ref_ids)
            if shared.sum() == 0:
                raise ValueError("No shared SNPs between 'geno' and 'gwas.geno'.")
            gwas_X = Xg[:, shared]
            ref_pos = {s: i for i, s in enumerate(ref_ids)}
            gwas_pos = np.array([ref_pos[s] for s in gw_ids[shared]])
        return build_tiled_ld(
            X, chisq=chisq, chrom=chrom_arg, tile=tile, stripe=stripe,
            dtype=np.float32 if dtype == jnp.float32 else np.float64,
            progress=progress, gwas_geno=gwas_X, gwas_pos=gwas_pos,
        )
    if map is None:
        ldchr = True
    else:
        chroms = np.asarray(map["Chr"] if isinstance(map, dict) else map[:, 1]).astype(str)
        if len(np.unique(chroms)) == 1:
            ldchr = True

    build_dense = _cov_dense_np

    def overlay(G):
        """Patch entries where both SNPs are in the GWAS panel with the GWAS
        panel's own covariance (tXXmat.cpp:388-416)."""
        if gwas_geno is None:
            return G
        if map is None or gwas_map is None:
            raise ValueError("map information for both panels should be provided.")
        ref_ids = np.asarray(map["SNP"] if isinstance(map, dict) else map[:, 0]).astype(str)
        gw_ids = np.asarray(
            gwas_map["SNP"] if isinstance(gwas_map, dict) else gwas_map[:, 0]
        ).astype(str)
        Xg = gwas_geno.values if hasattr(gwas_geno, "values") else np.asarray(gwas_geno)
        shared = np.isin(gw_ids, ref_ids)
        if shared.sum() == 0:
            raise ValueError("No shared SNPs between 'geno' and 'gwas.geno'.")
        Xg = Xg[:, shared]
        pos_in_ref = np.array(
            [np.flatnonzero(ref_ids == s)[0] for s in gw_ids[shared]]
        )
        Gg = build_dense(Xg)
        G[np.ix_(pos_in_ref, pos_in_ref)] = Gg
        return G

    if ldchr:
        G = overlay(build_dense(X))
        if chisq is None:
            return DenseLD(values=G)
        Gm, keep = _chisq_mask(jnp.asarray(G), n, chisq)
        keepn = np.asarray(keep)
        return SparseLD(values=np.asarray(Gm, dtype=np.float64), nnz_col=keepn.sum(axis=0))

    # per-chromosome blocks (tXXmat_Chr / tXXmat_Chr_gwas, tXXmat.cpp:504-840)
    if gwas_geno is not None:
        if gwas_map is None:
            raise ValueError("map information for gwas sample should be provided.")
        ref_ids = np.asarray(map["SNP"] if isinstance(map, dict) else map[:, 0]).astype(str)
        gw_ids = np.asarray(
            gwas_map["SNP"] if isinstance(gwas_map, dict) else gwas_map[:, 0]
        ).astype(str)
        Xg_all = gwas_geno.values if hasattr(gwas_geno, "values") else np.asarray(gwas_geno)

    blocks, sizes, nnzs = [], [], []
    order = []
    for c in dict.fromkeys(chroms):  # stable unique order
        idx = np.flatnonzero(chroms == c)
        order.append(idx)
        Gc = build_dense(X[:, idx])
        if gwas_geno is not None:
            # overlay the GWAS panel's own LD for SNPs shared on this chr
            chr_ids = ref_ids[idx]
            shared = np.isin(gw_ids, chr_ids)
            if shared.sum():
                Xg = Xg_all[:, shared]
                pos_in_chr = np.array(
                    [np.flatnonzero(chr_ids == s)[0] for s in gw_ids[shared]]
                )
                Gg = build_dense(Xg)
                Gc[np.ix_(pos_in_chr, pos_in_chr)] = Gg
        if chisq is not None:
            Gm, keep = _chisq_mask(jnp.asarray(Gc), n, chisq)
            Gc = np.asarray(Gm, dtype=np.float64)
            nnzs.append(np.asarray(keep).sum(axis=0))
        blocks.append(Gc)
        sizes.append(len(idx))
    order = np.concatenate(order)
    if not np.array_equal(order, np.arange(m)):
        raise ValueError(
            "SNPs must be ordered contiguously by chromosome for block LD; "
            "sort the genotype columns by the map first."
        )
    nnz_col = np.concatenate(nnzs) if nnzs else None
    return BlockDiagLD(blocks=blocks, sizes=sizes, nnz_col=nnz_col)
