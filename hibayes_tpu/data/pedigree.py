"""Pedigree processing: ordering, Henderson's A-inverse, partitions.

Device-side (JAX) counterpart of the reference's pedigree kernels
(reference: src/rm.cpp:56-229).  Graph ordering and sparse assembly are
host-side (irregular, data-dependent — not matrix work); the downstream solves
and imputation matmuls run on device.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

NA_TOKENS = {"NA", "Na", ".", "-", "NaN", "NAN", "nan", "na", "N/A", "n/a", "<NA>"}


def make_ped(ids, sires, dams, verbose=False):
    """Order the pedigree parents-before-offspring and integer-code parents.

    Mirrors the reference's iterative ordering with its two fallback passes
    (src/rm.cpp:56-170): founders first, then rows whose both parents are
    known; if stuck, rows with one known parent; if still stuck, force the
    rest.  Returns (ordered_ids, sire_idx, dam_idx) with 1-based parent
    positions (0 = unknown).
    """
    ids = [str(x) for x in ids]
    sires = [str(x) for x in sires]
    dams = [str(x) for x in dams]

    ped_id, ped_s, ped_d = [], [], []
    for p, s, d in zip(ids, sires, dams):
        if p in NA_TOKENS:
            continue
        ped_id.append(p)
        ped_s.append("0" if s in NA_TOKENS else s)
        ped_d.append("0" if d in NA_TOKENS else d)
    if len(set(ped_id)) != len(ped_id):
        raise ValueError("repeated records are not allowed in the first column of pedigree file.")
    n = len(ped_id)
    id_set = set(ped_id)

    out_id, out_s, out_d = [], [], []
    known = {"0"}
    remaining = np.ones(n, dtype=bool)

    # founders + parents referenced but never recorded become founders
    for i in range(n):
        if ped_s[i] == "0" and ped_d[i] == "0":
            known.add(ped_id[i])
            out_id.append(ped_id[i])
            out_s.append("0")
            out_d.append("0")
            remaining[i] = False
        else:
            for parent in (ped_s[i], ped_d[i]):
                if parent != "0" and parent not in id_set and parent not in known:
                    known.add(parent)
                    out_id.append(parent)
                    out_s.append("0")
                    out_d.append("0")

    while remaining.any():
        progressed = False
        for i in range(n):
            if not remaining[i]:
                continue
            if ped_s[i] in known and ped_d[i] in known:
                known.add(ped_id[i])
                out_id.append(ped_id[i])
                out_s.append(ped_s[i])
                out_d.append(ped_d[i])
                remaining[i] = False
                progressed = True
        if not progressed:
            for i in range(n):
                if not remaining[i]:
                    continue
                if ped_s[i] in known or ped_d[i] in known:
                    known.add(ped_id[i])
                    out_id.append(ped_id[i])
                    out_s.append(ped_s[i])
                    out_d.append(ped_d[i])
                    remaining[i] = False
                    progressed = True
        if not progressed:
            for i in range(n):
                if remaining[i]:
                    known.add(ped_id[i])
                    out_id.append(ped_id[i])
                    out_s.append(ped_s[i])
                    out_d.append(ped_d[i])
                    remaining[i] = False

    if not out_id:
        raise ValueError("no individuals detected.")
    pos = {"0": 0}
    for j, x in enumerate(out_id):
        pos[x] = j + 1
    s_idx = np.array([pos.get(s, 0) for s in out_s], dtype=np.int64)
    d_idx = np.array([pos.get(d, 0) for d in out_d], dtype=np.int64)
    return np.array(out_id), s_idx, d_idx


def make_ainv(s_idx, d_idx, compat_hibayes=False):
    """Henderson's sparse A-inverse from an ordered pedigree.

    Both-parents rules: diag +2, parent links -1, parent-parent +0.5
    (src/rm.cpp:188-194).  One-parent rules use the correct 4/3, -2/3, +1/3
    coefficients by default; ``compat_hibayes=True`` replicates the
    reference's C++ INTEGER-division quirk where 4/3 -> 1 and 2/3, 1/3 -> 0
    (src/rm.cpp:195-203), for bit-parity studies.
    """
    n = len(s_idx)
    rows, cols, vals = [], [], []

    if compat_hibayes:
        c_diag, c_link, c_par = 1.0, 0.0, 0.0
    else:
        c_diag, c_link, c_par = 4.0 / 3.0, -2.0 / 3.0, 1.0 / 3.0

    def add(i, j, v):
        rows.append(i)
        cols.append(j)
        vals.append(v)
        if i != j:
            rows.append(j)
            cols.append(i)
            vals.append(v)

    for x in range(n):
        sx = s_idx[x] - 1
        dx = d_idx[x] - 1
        if s_idx[x] == 0 and d_idx[x] == 0:
            add(x, x, 1.0)
        elif s_idx[x] > 0 and d_idx[x] > 0:
            add(x, x, 2.0)
            add(x, sx, -1.0)
            add(x, dx, -1.0)
            add(sx, sx, 0.5)
            add(dx, dx, 0.5)
            add(sx, dx, 0.5)
        elif s_idx[x] > 0:
            add(x, x, c_diag)
            add(x, sx, c_link)
            add(sx, sx, c_par)
        else:
            add(x, x, c_diag)
            add(x, dx, c_link)
            add(dx, dx, c_par)

    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsc()
    return A


def solve_a_ng(Ai_nn, Ai_ng):
    """A.ng = solve(Ai.nn, -Ai.ng): the imputation operator mapping genotyped
    to non-genotyped individuals (reference: R/ssbayes.r:296-301).  Sparse LU
    on host; the resulting dense operator feeds device matmuls.  Direct path
    for small pedigrees — at scale the dense (n_ng x n_g) operator is never
    materialised; see :class:`ImputationOperator`."""
    from scipy.sparse.linalg import splu

    lu = splu(sp.csc_matrix(Ai_nn))
    rhs = -np.asarray(Ai_ng.todense() if sp.issparse(Ai_ng) else Ai_ng)
    return lu.solve(rhs)


def coo_device(A):
    """Sparse matrix -> (rows, cols, vals) device arrays for the O(nnz)
    segment-sum matvec (device-side sparse A-inverse operator)."""
    import jax.numpy as jnp

    coo = sp.coo_matrix(A)
    return (jnp.asarray(coo.row.astype(np.int32)),
            jnp.asarray(coo.col.astype(np.int32)),
            jnp.asarray(coo.data))


class ImputationOperator:
    """Matrix-free A.ng = Ai_nn^{-1} (-Ai_ng): applies the imputation operator
    to column blocks with diagonally preconditioned batched CG on device
    (matvec = COO segment-sum over the pedigree sparsity, O(nnz) per column).

    Replaces the dense (n_ng x n_g) operator of :func:`solve_a_ng` at scale
    (reference does the dense solve in R's Matrix package,
    R/ssbayes.r:296-301; 100k-id pedigrees make that a >10 GB matrix).
    """

    def __init__(self, Ai_nn, Ai_ng, tol=1e-8, maxiter=None):
        import jax.numpy as jnp

        self.n_ng, self.n_g = Ai_ng.shape
        self.tol = tol
        self.maxiter = maxiter if maxiter is not None else 10 * self.n_ng
        nn = sp.csr_matrix(Ai_nn)
        self._nn_csr = nn
        self._rows, self._cols, self._vals = coo_device(nn)
        self._diag = jnp.asarray(nn.diagonal())
        self._Ai_ng = sp.csr_matrix(Ai_ng)

    def apply(self, V) -> np.ndarray:
        """A.ng @ V for dense V of shape (n_g, k) (or (n_g,)) — batched PCG
        with mixed-precision iterative refinement; never materialises A.ng.

        The device solve runs in whatever precision jax provides (f32 unless
        jax_enable_x64); residuals are recomputed in f64 on host against the
        scipy sparse matvec and the correction re-solved, so the final
        solution reaches f64 accuracy even on an f32-only device — the
        standard mixed-precision refinement loop."""
        V = np.asarray(V)
        squeeze = V.ndim == 1
        if squeeze:
            V = V[:, None]
        B = -(self._Ai_ng @ np.asarray(V, np.float64))
        nn = self._nn_csr
        X = np.zeros_like(B)
        bnorm = max(float(np.abs(B).max()), 1e-30)
        solve = _get_coo_pcg_solve()
        inner_tol = self.tol
        for _ in range(6):
            R = B - nn @ X  # exact f64 residual on host
            rel = float(np.abs(R).max()) / bnorm
            if rel < self.tol:
                break
            dX, it = solve(
                self.n_ng, min(self.maxiter, 1500), self._rows, self._cols,
                self._vals, self._diag, R, max(inner_tol, 1e-6),
            )
            dX = np.asarray(dX, np.float64)
            if not np.isfinite(dX).all():  # f32 stall guard: fall back
                from scipy.sparse.linalg import splu

                X = splu(self._nn_csr.tocsc()).solve(B)
                break
            X = X + dX
        return X[:, 0] if squeeze else X

    def impute(self, M, rows_needed=None, chunk_cols=2048,
               verbose=False) -> np.ndarray:
        """Mn[rows_needed] = (A.ng @ M)[rows_needed], solved in column chunks
        of M so peak memory is O(n_ng * chunk) (R/ssbayes.r:305 at scale)."""
        M = np.asarray(M)
        m = M.shape[1]
        rows_needed = (np.arange(self.n_ng) if rows_needed is None
                       else np.asarray(rows_needed))
        out = np.empty((len(rows_needed), m), dtype=np.float64)
        for c0 in range(0, m, chunk_cols):
            c1 = min(m, c0 + chunk_cols)
            out[:, c0:c1] = self.apply(M[:, c0:c1])[rows_needed]
            if verbose:
                print(f"\rimputing genotypes: {100 * c1 // m}%", end="", flush=True)
        if verbose:
            print()
        return out


def _coo_pcg_solve_impl(n_ng, maxiter, rows, cols, vals, diag, rhs, tol):
    import jax

    from ..math.solvers import pcg_batched

    def matvec_block(X):
        return jax.ops.segment_sum(
            vals[:, None] * X[cols], rows, num_segments=n_ng
        )

    return pcg_batched(matvec_block, rhs, diag=diag, tol=tol, maxiter=maxiter)


_coo_pcg_solve = None  # jitted lazily (jax import kept off the module path)


def _get_coo_pcg_solve():
    """Batched PCG against the COO segment-sum matvec, jitted ONCE at module
    level with the sparse arrays as ARGUMENTS (closure capture would bake the
    O(nnz) arrays into the executable as constants and trigger XLA constant
    folding on every compile)."""
    global _coo_pcg_solve
    if _coo_pcg_solve is None:
        import functools

        import jax

        _coo_pcg_solve = functools.partial(
            jax.jit(_coo_pcg_solve_impl, static_argnums=(0, 1))
        )
    return _coo_pcg_solve


def rcm_permutation(A) -> np.ndarray:
    """Reverse-Cuthill-McKee ordering of a symmetric sparse matrix —
    clusters pedigree families so the A-inverse(nn) block becomes banded and
    packs efficiently into the tiled-sparse layout used by the in-chain
    epsilon Gibbs."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return np.asarray(reverse_cuthill_mckee(sp.csr_matrix(A), symmetric_mode=True))


def read_pedigree(path: str, header=True):
    """Read a 3-column (id, sire, dam) pedigree file."""
    with open(path) as f:
        lines = [line.split() for line in f if line.strip()]
    if header:
        lines = lines[1:]
    ids = np.array([l[0] for l in lines])
    sires = np.array([l[1] if len(l) > 1 else "0" for l in lines])
    dams = np.array([l[2] if len(l) > 2 else "0" for l in lines])
    return ids, sires, dams
