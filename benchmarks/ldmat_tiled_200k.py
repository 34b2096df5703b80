"""Streaming tiled LD construction at m=200,000 (on-device tile selection).

Prints wall seconds, stored tiles and peak host RSS; the device is named on
the last line (no H100 measurement is recorded yet).
"""

import resource
import time

import jax
import numpy as np

from hibayes_tpu.data.sparse_ld import build_tiled_ld

rng = np.random.default_rng(0)
n, m = 5000, 200_000
raw = rng.integers(0, 256, size=(n, m), dtype=np.uint8)
X = np.ones((n, m), dtype=np.int8)
X[raw < 125] = 0
X[raw >= 200] = 2
cp = rng.random((n, 64)) < 0.5
for j in range(1, m):
    X[cp[:, j % 64], j] = X[cp[:, j % 64], j - 1]
t0 = time.time()
ld = build_tiled_ld(X, chisq=30.0, tile=128, stripe=8192, progress=True)
el = time.time() - t0
rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
print(f"ldmat tiled m=200k: {el:.0f}s, tiles={ld.n_tiles} "
      f"({ld.nbytes()/1e9:.2f} GB vs dense {m*m*8/1e9:.0f} GB), "
      f"peak RSS {rss:.1f} GB")
dev = jax.devices()[0]
print(f"device: {dev.platform}/{dev.device_kind} x{len(jax.devices())}")
