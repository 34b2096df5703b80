"""Device mesh + sharding rules.

The reference has no distributed layer at all (SURVEY.md section 2.3: OpenMP
threads + multithreaded BLAS in one process).  This design scales two data
axes over a mesh:

* ``ind`` — individuals (n).  The genotype's row axis.  Both hot matmuls of
  the blocked Gibbs sweep (r0 = X_b^T yadj and yadj += X_b dg) contract over
  n, so XLA turns the per-block reduction into a psum while the O(B)
  draws run replicated.  Sharding this axis keeps the chain
  *mathematically exact* — the same Markov kernel, just distributed.
* ``snp`` — markers (m).  Genuine model parallelism: X/W SNP-block shards
  live only on their owning device and the sweep runs shards in turn
  with psum-merged residual corrections (engine/gibbs._sweep_snp_sharded) —
  the same Markov kernel, no full-genotype gather; also shards LD tiles and
  the GEBV/posterior matmuls.

Multi-host: `jax.distributed.initialize()` + the same named shardings; the
n-axis psums stay within a host, the network between hosts only carries
scalar state.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..engine.gibbs import ChainState, GibbsData


def make_mesh(n_devices=None, shape=None, axis_names=("ind", "snp")):
    """Create a mesh over the first `n_devices` devices.

    shape: tuple like (4, 2) mapping devices to (ind, snp); default puts all
    devices on the `ind` axis (the exact data-parallel strategy).
    """
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    if shape is None:
        shape = (len(devices), 1)
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"mesh shape {shape} != device count {len(devices)}")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axis_names)


def shard_gibbs_data(data: GibbsData, mesh: Mesh) -> GibbsData:
    """Place GibbsData on the mesh: individual axis sharded, SNP-block Gram
    matrices sharded over the snp axis, small state replicated."""

    def put(x, spec):
        if x is None or (hasattr(x, "size") and x.size == 0):
            return x
        return jax.device_put(x, NamedSharding(mesh, spec))

    snp_size = mesh.shape.get("snp", 1)
    nblocks = data.X_blocks.shape[0]
    snp_divides = nblocks % max(snp_size, 1) == 0
    w_spec = P("snp", None, None) if snp_divides else P(None, None, None)
    # SNP-axis model parallelism: each device's HBM holds only its own SNP
    # blocks; the sweep runs shards in turn with psum-merged residual
    # corrections (engine/gibbs._sweep_snp_sharded) — exact chain
    x_spec = (
        P("snp", "ind", None)
        if snp_size > 1 and snp_divides
        else P(None, "ind", None)
    )
    return data._replace(
        y=put(data.y, P("ind")),
        X_blocks=put(data.X_blocks, x_spec),
        W_blocks=put(data.W_blocks, w_spec),
        xpx=put(data.xpx, P()),
        vx=put(data.vx, P()),
        real=put(data.real, P()),
        C=put(data.C, P("ind", None)) if data.C.size else data.C,
        cpc=put(data.cpc, P()),
        r_codes=tuple(put(c, P("ind")) for c in data.r_codes),
        r_counts=tuple(put(c, P()) for c in data.r_counts),
        fold=put(data.fold, P()),
        windindx0=put(data.windindx0, P()),
        K=put(data.K, P("ind", None)) if data.K.size else data.K,
        Kval=put(data.Kval, P()) if data.Kval.size else data.Kval,
        epsl_yJ=put(data.epsl_yJ, P("ind")) if data.epsl_yJ.size else data.epsl_yJ,
        epsl_LHS_A=data.epsl_LHS_A,
        epsl_codes=data.epsl_codes,
        epsl_counts=data.epsl_counts,
    )


def shard_sgibbs_data(data, mesh: Mesh):
    """Summary-engine placement: LD tiles + per-SNP vectors sharded over the
    snp axis (each device's HBM holds only its tile rows), scalars and r_hat
    state replicated.  Non-divisible tile-row counts stay replicated (the
    sweep then runs single-device semantics)."""

    def put(x, spec):
        if x is None or (hasattr(x, "size") and x.size == 0):
            return x
        return jax.device_put(x, NamedSharding(mesh, spec))

    snp_size = int(mesh.shape.get("snp", 1))
    if snp_size <= 1:
        return data
    if data.ld_tiles is None:
        import warnings

        warnings.warn(
            "mesh with an snp axis was requested but the LD is not tiled-"
            "sparse; the summary sweep will run single-device semantics "
            "(build the LD with ldmat(..., chisq=...) / TiledSparseLD to "
            "shard it)."
        )
        return data
    nbr = data.ld_tiles.shape[0]
    if nbr % snp_size != 0:
        import warnings

        warnings.warn(
            f"snp mesh axis ({snp_size}) does not divide the {nbr} LD tile "
            "rows; the summary sweep will run single-device semantics."
        )
        return data
    def put_rows(x):
        # per-SNP vector (m_pad,): contiguous split == block-row shards
        return put(x, P("snp"))

    return data._replace(
        ld_tiles=put(data.ld_tiles, P("snp", None, None, None)),
        ld_cols=put(data.ld_cols, P("snp", None)),
        ld_valid=put(data.ld_valid, P("snp", None)),
        xy=put_rows(data.xy),
        xpx=put_rows(data.xpx),
        vx=put_rows(data.vx),
        real=put_rows(data.real),
        varediff=put_rows(data.varediff),
        windindx0=put_rows(data.windindx0),
        fold=put(data.fold, P()),
        yy=put(data.yy, P()),
    )


def shard_state(state: ChainState, mesh: Mesh) -> ChainState:
    """Chain state: yadj/u/k_estR follow the individual axis, rest replicated.

    When the `ind` axis has size 1 the residuals are placed replicated (P())
    rather than P("ind") — that is the sharding the iteration step itself
    emits, and matching it keeps threaded state (step output fed back in,
    e.g. the segmented checkpoint runner) on the SAME jit cache entry
    instead of triggering a full second compile after the first call."""

    def put(x, spec):
        if x is None or (hasattr(x, "size") and x.size == 0):
            return x
        return jax.device_put(x, NamedSharding(mesh, spec))

    ind = P("ind") if int(mesh.shape.get("ind", 1)) > 1 else P()
    rep = lambda x: put(x, P())
    return state._replace(
        yadj=put(state.yadj, ind),
        u=put(state.u, ind),
        k_estR=put(state.k_estR, ind) if state.k_estR.size else state.k_estR,
        g=rep(state.g),
        nzrate=rep(state.nzrate),
        track=rep(state.track),
    )
