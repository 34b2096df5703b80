"""Chain checkpoint / resume.

The reference has no in-sampler recovery: a killed chain loses everything
(SURVEY.md aux #4).  Here the sampler state is O(n + m) and all randomness
derives from fold_in(base_key, state.it), so a snapshot of (state, collected
samples) resumes *bit-identically*: the restarted chain produces exactly the
draws the uninterrupted chain would have.

Scope: SINGLE-CONTROLLER only.  `save_checkpoint` gathers every state leaf to
host via `np.asarray`, which requires all shards to be addressable from this
process — fine for any single-host mesh (1..N local devices), but a multi-host
(`jax.distributed`) chain must either checkpoint per-host-addressable shards
itself or use an orbax-style distributed checkpointer.  The multi-host loader
path (`parallel/distributed.py`) documents the same boundary.
"""

from __future__ import annotations

import json
import os

import jax
import numpy as np


def save_checkpoint(path: str, state, samples_so_far: dict):
    """Write state leaves + partial samples to <path>.npz (atomic rename)."""
    leaves = jax.tree_util.tree_leaves(state)
    payload = {f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)}
    for k, v in samples_so_far.items():
        payload[f"sample_{k}"] = np.asarray(v)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path + ".npz")
    with open(path + ".meta.json", "w") as f:
        json.dump({"n_leaves": len(leaves),
                   "sample_keys": sorted(samples_so_far.keys()),
                   # leaves[0] is the iteration counter: scalar for a single
                   # chain, (K,) for a batched multi-chain state
                   "it": int(np.asarray(leaves[0]).reshape(-1)[0])}, f)


def load_checkpoint(path: str, template_state):
    """Rebuild (state, samples_so_far) from <path>.npz using the template's
    pytree structure.  Returns None if no checkpoint exists."""
    if not os.path.exists(path + ".npz"):
        return None
    data = np.load(path + ".npz")
    treedef = jax.tree_util.tree_structure(template_state)
    tmpl_leaves = jax.tree_util.tree_leaves(template_state)
    leaves = []
    for i, tl in enumerate(tmpl_leaves):
        arr = data[f"leaf_{i}"]
        leaves.append(jax.numpy.asarray(arr, dtype=tl.dtype))
    state = jax.tree_util.tree_unflatten(treedef, leaves)
    samples = {
        k[len("sample_"):]: data[k] for k in data.files if k.startswith("sample_")
    }
    return state, samples
