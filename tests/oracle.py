"""NumPy oracle: a direct sequential transcription of the reference sampler's
per-iteration semantics (src/Bayes.cpp:477-823), consuming exactly the same
random streams as the JAX engine.

This is the parity harness: since the reference uses R's RNG and we use
threefry, chains cannot be bit-matched across frameworks; instead this oracle
re-implements the reference's *sequential* update order in NumPy and draws its
randomness from the same deterministic streams as the blocked engine.  If the
blocked engine matches the oracle, it matches the reference's math.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from hibayes_tpu.engine import gibbs as G


def _norm(key, shape=()):
    return np.asarray(jax.random.normal(key, shape, dtype=jnp.float64))


def _unif(key, shape=()):
    return np.asarray(jax.random.uniform(key, shape, dtype=jnp.float64))


def _chisq(key, df, shape=()):
    return np.asarray(
        2.0 * jax.random.gamma(key, jnp.asarray(df, jnp.float64) / 2.0, shape, dtype=jnp.float64)
    )


def _gamma_vec(key, alpha):
    return np.asarray(jax.random.gamma(key, jnp.asarray(alpha, jnp.float64), dtype=jnp.float64))


def _inv_gaussian_from(z, u, mu, lam):
    y = z * z
    x = mu + 0.5 * mu * mu * y / lam - 0.5 * (mu / lam) * np.sqrt(
        4.0 * mu * lam * y + mu * mu * y * y
    )
    return x if u <= mu / (mu + x) else mu * mu / x


def oracle_iteration(spec, dnp, base_key, st):
    """One sequential reference iteration.  ``dnp`` holds numpy data arrays;
    ``st`` is a dict state (modified copy returned)."""
    st = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in st.items()}
    n, m_pad = spec.n, spec.m_pad
    key = jax.random.fold_in(base_key, st["it"])
    X, W = dnp["X"], None  # oracle works directly on X columns
    yadj, u, g = st["yadj"], st["u"], st["g"]
    ve = st["vare"]
    mi = spec.model_index

    # intercept
    z = _norm(jax.random.fold_in(key, G.STREAM_MU))
    delta = yadj.sum() / n + np.sqrt(ve / n) * z
    st["mu"] += delta
    yadj -= delta

    # covariates
    if spec.nc:
        zc = _norm(jax.random.fold_in(key, G.STREAM_COV), (spec.nc,))
        for i in range(spec.nc):
            ci = dnp["C"][:, i]
            cpc = ci @ ci
            old = st["beta"][i]
            rhs = ci @ yadj + cpc * old
            bi = rhs / cpc + np.sqrt(ve / cpc) * zc[i]
            yadj += (old - bi) * ci
            st["beta"][i] = bi

    # env random effects
    for i in range(len(spec.nlevels)):
        nlev = spec.nlevels[i]
        codes = dnp["r_codes"][i]
        counts = np.bincount(codes, minlength=nlev).astype(np.float64)
        old = st["estR"][i]
        kz = jax.random.fold_in(key, G.STREAM_FACTOR + 2 * i)
        kchi = jax.random.fold_in(key, G.STREAM_FACTOR + 2 * i + 1)
        rhs = np.bincount(codes, weights=yadj, minlength=nlev) + counts * old
        lhs = counts + ve / st["vrtmp"][i]
        zr = _norm(kz, (nlev,))
        new = rhs / lhs + np.sqrt(ve / lhs) * zr
        yadj += (old - new)[codes]
        chi = _chisq(kchi, nlev + spec.dfr)
        st["vrtmp"][i] = (new @ new + spec.s2r * spec.dfr) / chi
        st["vr"][i] = np.var(new, ddof=1)
        st["estR"][i] = new

    # pre-generated per-SNP randoms (same streams as the engine); BayesR uses
    # n_fold uniforms per SNP for the Gumbel-max categorical fold draw
    z_snp = _norm(jax.random.fold_in(key, G.STREAM_SNP_Z), (m_pad,))
    ushape = (m_pad, spec.n_fold) if spec.model_index == 6 else (m_pad,)
    u_snp = _unif(jax.random.fold_in(key, G.STREAM_SNP_U), ushape)
    chi_snp = _chisq(jax.random.fold_in(key, G.STREAM_SNP_CHI), spec.dfvara + 1.0, (m_pad,))
    z2_snp = _norm(jax.random.fold_in(key, G.STREAM_SNP_Z2), (m_pad,))

    xpx, vx = dnp["xpx"], dnp["vx"]
    logpi = np.log(np.maximum(st["pi"], 1e-300))
    s2varg_df = spec.s2varg * spec.dfvara
    varg = st["varg"]
    vargi_acc = 0.0
    vargR_acc = 0.0
    track = np.zeros(m_pad, dtype=np.int64)
    fold = dnp["fold"]
    vara_fold = st["vara_fold"]
    ve_vara_fold = ve / np.maximum(vara_fold, 1e-30)

    for j in range(m_pad):
        if vx[j] <= 0:
            continue
        xj = X[:, j]
        xx = xpx[j]
        old = g[j]
        rhs = xj @ yadj + xx * old
        gi = 0.0
        if mi == 1:
            v = xx + ve / varg
            gi = rhs / v + np.sqrt(ve / v) * z_snp[j]
        elif mi == 2:
            vj = (old * old + s2varg_df) / chi_snp[j]
            v = xx + ve / vj
            gi = rhs / v + np.sqrt(ve / v) * z_snp[j]
        elif mi in (3, 4):
            vj = (old * old + s2varg_df) / chi_snp[j] if mi == 3 else varg
            lhs = xx / ve
            logdetV = np.log(vj * lhs + 1.0)
            v = xx + ve / vj
            uhat = rhs / v
            s1 = -0.5 * (logdetV - rhs * uhat / ve) + logpi[1]
            accept0 = 1.0 / (1.0 + np.exp(s1 - logpi[0]))
            ind = 0 if u_snp[j] < accept0 else 1
            track[j] = ind
            if ind:
                gi = rhs / v + np.sqrt(ve / v) * z_snp[j]
                if mi == 4:
                    vargi_acc += gi * gi
        elif mi == 5:
            v = xx + 1.0 / st["vargL"][j]
            gi = rhs / v + np.sqrt(ve / v) * z_snp[j]
            if abs(gi) < 1e-6:
                gi = 1e-6
            lam2 = st["lambda2"]
            lam = np.sqrt(lam2)
            vgi = 1.0 / _inv_gaussian_from(z2_snp[j], u_snp[j], np.sqrt(ve) * lam / abs(gi), lam2)
            ok = vgi > 0 if spec.vargl_strict_pos else vgi >= 0
            if ok:
                st["vargL"][j] = vgi
        else:  # BayesR — Gumbel-max categorical fold draw (engine-identical)
            lhs = xx / ve
            s = logpi.copy()
            for f in range(1, spec.n_fold):
                logdetV = np.log(vara_fold[f] * lhs + 1.0)
                uhat = rhs / (xx + ve_vara_fold[f])
                s[f] = -0.5 * (logdetV - rhs * uhat / ve) + logpi[f]
            gum = -np.log(-np.log(np.maximum(u_snp[j], 1e-12)))
            ind = int(np.argmax(s + gum))
            track[j] = ind
            if ind:
                v = xx + ve_vara_fold[ind]
                gi = rhs / v + np.sqrt(ve / v) * z_snp[j]
                vargR_acc += gi * gi / fold[ind]
        dg = old - gi
        if dg != 0.0:
            yadj += dg * xj
            u -= dg * xj
        g[j] = gi

    # variance / mixture updates
    m_real, nvar0 = spec.m, spec.nvar0
    kvarg = jax.random.fold_in(key, G.STREAM_VARG)
    kpi = jax.random.fold_in(key, G.STREAM_PI)
    real = np.arange(m_pad) < m_real
    if mi == 1:
        chi = _chisq(kvarg, spec.dfvara + m_real - nvar0)
        st["varg"] = (g @ g + s2varg_df) / chi
    elif mi == 3:
        nnz = track[real].sum()
        fold_num = np.array([m_real - nvar0 - nnz, nnz], dtype=np.float64)
        if not spec.fixpi:
            gam = _gamma_vec(kpi, fold_num + 1.0)
            st["pi"] = gam / gam.sum()
    elif mi == 4:
        nnz = float((track[real] == 1).sum())
        chi = _chisq(kvarg, spec.dfvara + nnz)
        st["varg"] = (vargi_acc + s2varg_df) / chi
        fold_num = np.array([m_real - nvar0 - nnz, nnz])
        if not spec.fixpi:
            gam = _gamma_vec(kpi, fold_num + 1.0)
            st["pi"] = gam / gam.sum()
    elif mi == 5:
        shape = spec.lambda_shape0 + m_real - nvar0
        rate = spec.lambda_rate0 + st["vargL"][real].sum() / 2.0
        gdraw = np.asarray(
            jax.random.gamma(jax.random.fold_in(key, G.STREAM_LAMBDA), jnp.float64(shape), dtype=jnp.float64)
        )
        st["lambda2"] = gdraw / rate
    elif mi == 6:
        fold_num = np.array(
            [float(((track == f) & real).sum()) for f in range(spec.n_fold)]
        )
        nnz = m_real - fold_num[0]
        chi = _chisq(kvarg, spec.dfvara + nnz)
        st["varg"] = (vargR_acc + s2varg_df) / chi
        st["vara_fold"] = st["varg"] * fold
        fold_num[0] -= nvar0
        if not spec.fixpi:
            gam = _gamma_vec(kpi, fold_num + 1.0)
            st["pi"] = gam / gam.sum()

    st["vara"] = np.var(u, ddof=1)
    chi_e = _chisq(jax.random.fold_in(key, G.STREAM_VE), n + spec.dfvare)
    st["vare"] = (yadj @ yadj + spec.s2vare * spec.dfvare) / chi_e
    st["track"] = track
    st["yadj"], st["u"], st["g"] = yadj, u, g
    st["it"] += 1
    return st


def guarded_draws_oracle(spec, P, W, r0):
    """Sequential f64 transcription of one block's packed-row draws under
    the SBayesS rejection guard (BayesC / BayesR, retry rows appended by
    `ops.blockgibbs._pack_retry_rows`; src/SBayesS.cpp:388-398 with bounded
    retries).  P (K, R, B), W (B, B), r0 (K, B).  Returns
    (dg (K, B), track (K, B), number of rejected first draws)."""
    from hibayes_tpu.ops import blockgibbs as BG

    P = np.asarray(P, np.float64)
    W = np.asarray(W, np.float64)
    r0 = np.asarray(r0, np.float64)
    K, _, B = P.shape
    mi, nf = spec.model_index, spec.n_fold
    base = BG._guard_base(spec)
    dg = np.zeros((K, B))
    track = np.zeros((K, B), np.int64)
    n_rej = 0
    for k in range(K):
        for j in range(B):
            p = P[k, :, j]
            rhs = r0[k, j] + W[j, :j] @ dg[k, :j] + p[0]
            if mi == 4:
                ind = int(rhs * rhs >= p[4])
                gi = rhs * p[2] + p[3] if ind else 0.0
                cands = [rhs * p[2] + p[base + 1 + r] for r in range(BG.N_RETRY)]
            else:
                logits = [p[2 + 4 * (nf - 1)]] + [
                    p[2 + 4 * (f - 1)] + p[3 + 4 * (f - 1)] * rhs * rhs
                    for f in range(1, nf)]
                ind = int(np.argmax(logits))
                gi = (rhs * p[4 + 4 * (ind - 1)] + p[5 + 4 * (ind - 1)]
                      if ind else 0.0)
                cands = [rhs * p[4 + 4 * (ind - 1)]
                         + p[base + 1 + r * (nf - 1) + (ind - 1)]
                         for r in range(BG.N_RETRY)]
            if ind and gi * gi * p[base] > spec.vary:
                n_rej += 1
                for c in cands:
                    gi = c
                    if gi * gi * p[base] <= spec.vary:
                        break
                else:
                    gi = 0.0
            dg[k, j] = p[1] - gi
            track[k, j] = ind
    return dg, track, n_rej
