"""Genomic relationship matrix (GRM) on the device.

Device-side (JAX) equivalent of the reference's BLAS dsyrk path
(reference: src/rm.cpp:5-53): center columns, G = Zc Zc^T, normalise by
mean(diag), optional inverse / eigendecomposition (for BSLMM).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

HIGHEST = jax.lax.Precision.HIGHEST


def make_grm(M, lambda_=0.0, inverse=False, eigen=False, dtype=None):
    M_np = np.asarray(M)
    out_dt = dtype or jnp.result_type(M_np, jnp.float32)
    if np.issubdtype(M_np.dtype, np.integer) and M_np.dtype.itemsize == 1:
        # int8 fast path: Zc Zc' = MM' - v1' - 1v' + (mu.mu) 11' with
        # MM' exact in int32 and the rank-1 mean corrections in out_dt
        Mi = jnp.asarray(M_np)
        S = jax.lax.dot_general(
            Mi, Mi, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32
        ).astype(out_dt)
        mu = jnp.mean(Mi.astype(out_dt), axis=0)
        v = jnp.matmul(Mi.astype(out_dt), mu, precision=HIGHEST)
        G = S - v[:, None] - v[None, :] + jnp.dot(mu, mu, precision=HIGHEST)
    else:
        Mj = jnp.asarray(M_np, out_dt)
        Zc = Mj - jnp.mean(Mj, axis=0, keepdims=True)
        G = jnp.matmul(Zc, Zc.T, precision=HIGHEST)
    G = G / jnp.mean(jnp.diag(G))
    if inverse:
        if lambda_:
            G = G + lambda_ * jnp.eye(G.shape[0], dtype=G.dtype)
        return jnp.linalg.inv(G)
    if eigen:
        if lambda_:
            G = G + lambda_ * jnp.eye(G.shape[0], dtype=G.dtype)
        vals, vecs = jnp.linalg.eigh(G)
        return vals, vecs
    return G
