"""Linear solvers: conjugate gradient and diagonally preconditioned CG.

Device-side (JAX) equivalents of the reference's solvers (src/solver.cpp:3-117):
pure functional lax.while_loop implementations over an abstract matvec, so
the same code serves dense LD, chromosome-block LD, and sparse A-inverse
operators; XLA fuses the vector work and keeps matvecs on the device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST


def conj_grad(matvec, b, lam=None, x0=None, tol=1e-6, maxiter=None):
    """Plain CG with optional per-element ridge `lam` (solver.cpp:54-117).

    Solves (A + diag(lam)) x = b.  Returns (x, iterations, final_err).
    """
    b = jnp.asarray(b)
    m = b.shape[0]
    maxiter = m if maxiter is None else maxiter
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)

    def amul(v):
        out = matvec(v)
        if lam is not None:
            out = out + v * lam
        return out

    r = b - amul(x)
    p = r
    r2 = jnp.dot(r, r, precision=HIGHEST)

    def cond(c):
        x, r, p, r2, it, err = c
        return (err >= tol) & (it < maxiter)

    def body(c):
        x, r, p, r2, it, err = c
        ap = amul(p)
        alpha = r2 / jnp.dot(p, ap, precision=HIGHEST)
        x = x + alpha * p
        r = r - alpha * ap
        r2new = jnp.dot(r, r, precision=HIGHEST)
        err = jnp.sqrt(r2new)
        beta = r2new / r2
        p = r + beta * p
        return (x, r, p, r2new, it + 1, err)

    err0 = jnp.sqrt(r2)
    x, r, p, r2, it, err = jax.lax.while_loop(
        cond, body, (x, r, p, r2, jnp.zeros((), jnp.int32), err0)
    )
    return x, it, err


def estimate_diag(matvec, m, nprobes=16, key=None, dtype=jnp.float64):
    """Stochastic diagonal estimate via Rademacher probes (Bekas et al.):
    E[v * Av] = diag(A) for v with iid +/-1 entries.  `nprobes` matvecs."""
    if key is None:
        key = jax.random.PRNGKey(0)
    probes = jax.random.rademacher(key, (nprobes, m), dtype=dtype)
    av = jax.vmap(matvec)(probes)
    return jnp.mean(probes * av, axis=0)


def pcg(matvec, b, x0=None, tol=1e-6, maxiter=None, nprobes=16):
    """Jacobi-preconditioned CG (solver.cpp:3-42).  The preconditioner is the
    operator diagonal estimated via `estimate_diag` Rademacher probes —
    callers with an explicit diagonal should use `pcg_with_diag`."""
    b = jnp.asarray(b)
    diag = estimate_diag(matvec, b.shape[0], nprobes=nprobes, dtype=b.dtype)
    # the probe estimate can be noisy/nonpositive off-SPD — clamp to positive
    diag = jnp.where(diag > 0, diag, 1.0)
    return pcg_with_diag(matvec, b, diag, x0=x0, tol=tol, maxiter=maxiter)


def pcg_batched(matvec, B, diag=None, tol=1e-8, maxiter=None):
    """Jacobi-preconditioned CG over a BATCH of right-hand sides (n, k):
    the block variant of the reference's PCGm (src/solver.cpp:44-52).
    `matvec` maps (n, k) -> (n, k) column-wise (apply A to every column).
    Per-column step sizes; stops when every column's residual norm < tol
    relative to its RHS norm.  Returns (X, iterations)."""
    B = jnp.asarray(B)
    n, k = B.shape
    maxiter = n if maxiter is None else maxiter
    if diag is None:
        minv = jnp.ones((n, 1), B.dtype)
    else:
        d = jnp.where(diag == 0, 1e-4, diag)
        minv = (1.0 / d).reshape(n, 1)
    bnorm = jnp.maximum(jnp.linalg.norm(B, axis=0), 1e-30)
    X = jnp.zeros_like(B)
    R = B - matvec(X)
    Z = minv * R
    P = Z

    def cdot(a, b):
        return jnp.sum(a * b, axis=0)  # (k,)

    def cond(c):
        X, R, Z, P, rz, it = c
        err = jnp.linalg.norm(R, axis=0) / bnorm
        return (jnp.max(err) > tol) & (it < maxiter)

    def body(c):
        X, R, Z, P, rz, it = c
        AP = matvec(P)
        a = rz / jnp.maximum(cdot(P, AP), 1e-300)
        X = X + a[None, :] * P
        R1 = R - a[None, :] * AP
        Z1 = minv * R1
        rz1 = cdot(Z1, R1)
        beta = rz1 / jnp.maximum(rz, 1e-300)
        P = Z1 + beta[None, :] * P
        return (X, R1, Z1, P, rz1, it + 1)

    rz0 = cdot(Z, R)
    X, R, Z, P, rz, it = jax.lax.while_loop(
        cond, body, (X, R, Z, P, rz0, jnp.zeros((), jnp.int32))
    )
    return X, it


def pcg_with_diag(matvec, b, diag, x0=None, tol=1e-6, maxiter=None):
    b = jnp.asarray(b)
    m = b.shape[0]
    maxiter = m if maxiter is None else maxiter
    if diag is None:
        minv = jnp.ones_like(b)
    else:
        d = jnp.where(diag == 0, 1e-4, diag)
        minv = 1.0 / d
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    r = b - matvec(x)
    z = minv * r
    p = z

    def cond(c):
        x, r, z, p, it = c
        return (jnp.linalg.norm(r) > tol) & (it < maxiter)

    def body(c):
        x, r, z, p, it = c
        ap = matvec(p)
        a = jnp.dot(r, z, precision=HIGHEST) / jnp.dot(p, ap, precision=HIGHEST)
        x = x + a * p
        r1 = r - a * ap
        z1 = minv * r1
        beta = jnp.dot(z1, r1, precision=HIGHEST) / jnp.dot(z, r, precision=HIGHEST)
        p = z1 + beta * p
        return (x, r1, z1, p, it + 1)

    x, r, z, p, it = jax.lax.while_loop(cond, body, (x, r, z, p, jnp.zeros((), jnp.int32)))
    return x, it
