"""Steady-state cost of the single-step epsilon sweep at qe ~= 80k


The in-chain epsilon term runs `blocked_mme_gibbs_sparse` — a single-site
Gibbs sweep over LHS = scale*A_inv(nn) + diag(counts) (reference analogue:
src/solver.cpp:131-140 over arma::sp_mat) — once per MCMC iteration.  This
measures it in isolation on a pedigree-shaped A-inverse: 100k-id pedigree,
20k genotyped -> qe = 80k epsilon sites, RCM-reordered as ssbrm does.

Usage: python benchmarks/epsl_sweep_80k.py [quick]
"""

import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from hibayes_tpu.data.pedigree import make_ainv, make_ped, rcm_permutation
from hibayes_tpu import runtime
from hibayes_tpu.engine import gibbs as G


def build(nfound=20_000, nkid=80_000, geno_frac=0.2, tile=128, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.array([f"f{i}" for i in range(nfound)]
                   + [f"k{i}" for i in range(nkid)])
    # kids pick parents among founders + earlier kids (generational structure
    # with popular sires, the pattern that breaks tile-sparse layouts)
    sires, dams = ["0"] * nfound, ["0"] * nfound
    pool = list(ids[:nfound])
    popular = rng.choice(nfound, 200, replace=False)
    for i in range(nkid):
        if rng.random() < 0.5:
            s = ids[popular[rng.integers(200)]]
        else:
            s = pool[rng.integers(len(pool))]
        d = pool[rng.integers(len(pool))]
        sires.append(s)
        dams.append(d)
        if i % 3 == 0:
            pool.append(ids[nfound + i])
    ped_ids, s_idx, d_idx = make_ped(ids, np.array(sires), np.array(dams))
    Ai = make_ainv(s_idx, d_idx)
    # non-genotyped block: drop a random geno_frac of ids
    geno = rng.random(len(ped_ids)) < geno_frac
    ng_indx = np.flatnonzero(~geno)
    Ai_nn = Ai.tocsr()[ng_indx].tocsc()[:, ng_indx]
    perm = rcm_permutation(Ai_nn)
    Ai_nn = Ai_nn.tocsr()[perm].tocsc()[:, perm]
    qe = Ai_nn.shape[0]
    sp_obj, qe_pad = G._build_epsl_sparse(Ai_nn, tile, jnp.float32)
    print(f"qe={qe} (pad {qe_pad}), nnz={Ai_nn.nnz}, "
          f"tiles(nbr)={sp_obj.diag_blocks.shape[0]} "
          f"P(max triplets/block)={sp_obj.blk_rows.shape[1]}")
    return sp_obj, qe, qe_pad


def main():
    quick = "quick" in sys.argv
    sp_obj, qe, qe_pad = build(nfound=5_000 if quick else 20_000,
                               nkid=20_000 if quick else 80_000)
    rng = np.random.default_rng(1)
    counts = jnp.asarray((rng.random(qe_pad) < 0.3).astype(np.float32))
    x0 = jnp.zeros(qe_pad, jnp.float32)
    b = jnp.asarray(rng.normal(0, 1, qe_pad).astype(np.float32))
    z = jnp.asarray(rng.normal(0, 1, qe_pad).astype(np.float32))

    iters = 20
    for use_pallas in sorted({False, runtime.use_kernels()}):
        step = jax.jit(lambda x, z: G.blocked_mme_gibbs_sparse(
            sp_obj, counts, jnp.float32(1.7), x, b, jnp.float32(1.0), z,
            use_pallas=use_pallas))
        x, _ = jax.block_until_ready(step(x0, z))
        t0 = time.time()
        for _ in range(iters):
            x, _ = step(x, z)
        jax.block_until_ready(x)
        dt = (time.time() - t0) / iters
        lbl = "pallas kernel" if use_pallas else "XLA site scan"
        dev = jax.devices()[0]
        print(f"epsilon sweep [{lbl}] on {dev.platform}/{dev.device_kind}: "
              f"{dt*1e3:.1f} ms/iter at qe={qe} "
              f"({qe/dt/1e6:.2f}M site-updates/s)", flush=True)


if __name__ == "__main__":
    main()
