"""BASELINE config-5 shape: ssbrm on a 100,000-id pedigree / 20,000 genotyped
/ 10,000 phenotyped, matrix-free PCG imputation + sparse epsilon Gibbs.

The dense operators this path avoids would need 12.8 GB (A.ng) + 51.2 GB
(epsilon A-inverse) at this shape; the qe=80k epsilon sweep is measured
alone by benchmarks/epsl_sweep_80k.py.  No H100 measurement is recorded
yet.

Usage: python benchmarks/ssbrm_100k_pedigree.py [m] — default m=1000; pass
m=100000 for the combined pedigree-scale x SNP-scale configuration
(both axes big simultaneously, f32 genotype).
"""

import resource
import sys
import time

import jax
import numpy as np

import hibayes_tpu.model.ssbrm as SS

rng = np.random.default_rng(1)
nfound, nkid = 5000, 95_000
ids = [f"F{i}" for i in range(nfound)]
sires = ["0"] * nfound
dams = ["0"] * nfound
for k in range(nkid):
    ids.append(f"K{k}")
    sires.append(ids[rng.integers(0, len(ids) - 1)])
    dams.append(ids[rng.integers(0, len(ids) - 1)])
ids, sires, dams = map(np.array, (ids, sires, dams))
n_g = 20_000
m = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
geno_ids = rng.choice(ids, n_g, replace=False)
M = rng.binomial(2, 0.35, (n_g, m)).astype(np.int8)
others = np.setdiff1d(ids, geno_ids)
phe_ids = np.concatenate([rng.choice(geno_ids, 5000, replace=False),
                          rng.choice(others, 5000, replace=False)])
y = rng.normal(0, 1, len(phe_ids))
t0 = time.time()
fit = SS.ssbrm("y~1", data={"id": phe_ids, "y": y}, M=M, M_id=geno_ids,
               pedigree={"id": ids, "sire": sires, "dam": dams},
               method="BayesCpi", niter=60, nburn=30, thin=5,
               verbose=True, impute="pcg", chunk_cols=2048)
el = time.time() - t0
rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
print(f"m={m}: TOTAL {el:.0f}s, peak RSS {rss:.1f} GB, gebv {len(fit.g['id'])} "
      f"ids, finite={np.isfinite(fit.g['gebv']).all()}, Veps={fit.Veps:.3f}")
dev = jax.devices()[0]
print(f"device: {dev.platform}/{dev.device_kind} x{len(jax.devices())}")
