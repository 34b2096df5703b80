"""Multi-host execution helpers.

The reference is a single-process OpenMP library (SURVEY.md §2.3 P5: no
MPI/NCCL/sockets).  Here, multi-host scaling uses JAX's standard runtime:

* `init_multihost()` wraps `jax.distributed.initialize` — call once per host
  before any device use (coordinator address/process id come from the
  environment or arguments).
* The SAME named shardings used single-host (`parallel/mesh.py`) then span
  all hosts: `make_mesh()` over `jax.devices()` returns a global mesh; the
  `ind` axis psums stay within a host, the network between hosts only
  carries the replicated scalar state broadcast and checkpoint IO.

Single-controller-per-host SPMD: every host runs the identical `run_chain`
call; jax.Array global sharding handles the data placement.  Genotype loading
is host-sharded for real: `load_plink_host_sharded` computes this process's
row range from the mesh (`process_row_range`), decodes ONLY those individuals
from the memory-mapped .bed (`data/plink.py::read_plink(rows=...)`,
global-major-genotype imputation included), and assembles the global array
with `jax.make_array_from_process_local_data`.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from .mesh import make_mesh


def init_multihost(coordinator_address=None, num_processes=None, process_id=None):
    """Initialize the JAX distributed runtime (no-op if already initialized
    or single-process)."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        pass  # already initialized
    return jax.process_count(), jax.process_index()


def process_row_range(global_n: int, mesh, axis="ind") -> tuple:
    """(start, count) of the individual rows owned by THIS process under a
    P(axis) sharding of a length-``global_n`` axis over ``mesh``.

    The union of this process's addressable devices' index slices; contiguity
    holds for the standard row-major mesh construction (`make_mesh`).
    """
    sharding = NamedSharding(mesh, P(axis))
    idx_map = sharding.devices_indices_map((global_n,))
    pid = jax.process_index()
    starts, stops = [], []
    for dev, idx in idx_map.items():
        if dev.process_index != pid:
            continue
        sl = idx[0]
        starts.append(0 if sl.start is None else sl.start)
        stops.append(global_n if sl.stop is None else sl.stop)
    if not starts:
        return (0, 0)
    lo, hi = min(starts), max(stops)
    return (lo, hi - lo)


def host_sharded_genotype(local_rows: np.ndarray, mesh, axis="ind"):
    """Assemble a global (n, m) genotype jax.Array from this host's row shard.

    local_rows: this process's contiguous block of individuals (the range
    given by :func:`process_row_range`).  Returns a global array sharded over
    `axis`.
    """
    sharding = NamedSharding(mesh, P(axis, None))
    return jax.make_array_from_process_local_data(sharding, local_rows)


def load_plink_host_sharded(bfile: str, mesh, axis="ind", mode="A",
                            impute=True, max_chunk_bytes=1 << 30, threads=0):
    """Host-sharded PLINK ingestion: each process decodes only its own row
    range of the .bed payload and contributes it to a global sharded array.

    Returns ``(fileset, global_geno)`` where ``fileset`` is the usual
    read_plink dict whose ``geno.values`` is the LOCAL row shard, and
    ``global_geno`` is the global (n, m) int8 jax.Array sharded over ``axis``.
    """
    from ..data.plink import read_fam, read_plink

    fam = read_fam(bfile + ".fam")
    n = len(fam[0])
    rows = process_row_range(n, mesh, axis=axis)
    fileset = read_plink(
        bfile, impute=impute, mode=mode, max_chunk_bytes=max_chunk_bytes,
        threads=threads, rows=rows,
    )
    global_geno = host_sharded_genotype(fileset["geno"].values, mesh, axis=axis)
    return fileset, global_geno
