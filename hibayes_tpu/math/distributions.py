"""Distribution samplers for the Gibbs engines.

Device-side (JAX) equivalents of the reference's distribution kernels
(reference: src/stats.cpp:3-76).  Two flavours are provided:

* keyed samplers (``normal``, ``chisq`` ...) that draw from a JAX PRNG key —
  used for scalar / per-iteration draws;
* deterministic transforms (``inv_gaussian_from``, ``scaled_inv_chisq_from``)
  that map pre-generated standard normals / uniforms / chi-square draws to the
  target distribution.  The blocked-Gibbs inner scan consumes pre-generated
  random arrays indexed by SNP so the same arrays can drive both the JAX
  engine and the NumPy oracle used in the exactness tests.

All samplers respect the dtype of their inputs (f32 in production, f64 in the
CPU exactness tests).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def normal(key, mean=0.0, sd=1.0, shape=(), dtype=jnp.float32):
    """mean + sd * z.  (reference: src/stats.cpp:8-11)"""
    return mean + sd * jax.random.normal(key, shape, dtype=dtype)


def uniform(key, shape=(), dtype=jnp.float32):
    return jax.random.uniform(key, shape, dtype=dtype)


def gamma(key, shape_param, scale=1.0, shape=(), dtype=jnp.float32):
    """Gamma(shape, scale) with mean shape*scale. (reference: src/stats.cpp:13-15)"""
    return jax.random.gamma(key, shape_param, shape, dtype=dtype) * scale


def inv_gamma(key, shape_param, scale, shape=(), dtype=jnp.float32):
    return 1.0 / gamma(key, shape_param, 1.0 / scale, shape, dtype)


def chisq(key, df, shape=(), dtype=jnp.float32):
    """Chi-square via Gamma(df/2, 2). (reference: src/stats.cpp:22-24)"""
    return jax.random.gamma(key, jnp.asarray(df, dtype) / 2.0, shape, dtype=dtype) * 2.0


def inv_chisq(key, df, scale, shape=(), dtype=jnp.float32):
    """(df * scale) / chisq(df). (reference: src/stats.cpp:26-28)"""
    return (df * scale) / chisq(key, df, shape, dtype)


def scaled_inv_chisq_from(quad, df_scale_prod, df_total, chi_draw):
    """The sampler used for every variance update in the reference engines:
    ``(quadratic_form + s2 * df) / chisq(df_total)`` with a pre-generated
    chi-square draw.  (reference: src/Bayes.cpp:603,823)"""
    del df_total  # df only determines chi_draw's distribution; kept for clarity
    return (quad + df_scale_prod) / chi_draw


def beta(key, a, b, shape=(), dtype=jnp.float32):
    return jax.random.beta(key, a, b, shape, dtype=dtype)


def student_t(key, df, shape=(), dtype=jnp.float32):
    return jax.random.t(key, df, shape, dtype=dtype)


def cauchy(key, location=0.0, scale=1.0, shape=(), dtype=jnp.float32):
    return location + scale * jax.random.cauchy(key, shape, dtype=dtype)


def exponential(key, scale=1.0, shape=(), dtype=jnp.float32):
    return scale * jax.random.exponential(key, shape, dtype=dtype)


def laplace(key, mean=0.0, scale=1.0, shape=(), dtype=jnp.float32):
    """Inverse-CDF Laplace, same transform as reference src/stats.cpp:46-53."""
    u = jax.random.uniform(key, shape, dtype=dtype)
    return laplace_from(u, mean, scale)


def laplace_from(u, mean=0.0, scale=1.0):
    return jnp.where(
        u < 0.5,
        mean + scale * jnp.log(2.0 * u),
        mean - scale * jnp.log(2.0 * (1.0 - u)),
    )


def inv_gaussian_from(z, u, mu, lam):
    """Michael-Schucany-Haas inverse-Gaussian transform from a standard
    normal ``z`` and a uniform ``u``.  (reference: src/stats.cpp:55-67)"""
    y = z * z
    x = (
        mu
        + 0.5 * mu * mu * y / lam
        - 0.5 * (mu / lam) * jnp.sqrt(4.0 * mu * lam * y + mu * mu * y * y)
    )
    return jnp.where(u <= mu / (mu + x), x, mu * mu / x)


def inv_gaussian(key, mu, lam, shape=(), dtype=jnp.float32):
    kz, ku = jax.random.split(key)
    z = jax.random.normal(key=kz, shape=shape, dtype=dtype)
    u = jax.random.uniform(key=ku, shape=shape, dtype=dtype)
    return inv_gaussian_from(z, u, mu, lam)


def dirichlet(key, alpha, dtype=jnp.float32):
    """Normalised gammas. (reference: src/stats.cpp:69-76)"""
    x = jax.random.gamma(key, jnp.asarray(alpha, dtype), dtype=dtype)
    return x / jnp.sum(x)
