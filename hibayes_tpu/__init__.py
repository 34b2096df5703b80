"""hibayes_tpu: Bayesian whole-genome regression and GWAS on an NVIDIA GPU.

A JAX/XLA/Pallas framework with the capabilities of the hibayes R package
(individual-level `ibrm`, summary-level `sbrm`, single-step `ssbrm`
Bayesian models, LD matrix construction, PLINK ingestion): exact blocked
Gibbs on matrix products, Pallas-Triton kernels for the sequential draws,
mesh-sharded genotypes with psum-merged residual updates.
"""

from . import runtime
from .data.ld import BlockDiagLD, DenseLD, SparseLD, ldmat
from .data.plink import GenoMatrix, read_plink
from .data.sparse_ld import TiledSparseLD, build_tiled_ld
from .data.pedigree import read_pedigree
from .data.pheno import read_pheno
from .data.sumstats import read_sumstat
from .model.ibrm import ibrm
from .model.results import BlrMod
from .model.sbrm import sbrm
from .model.ssbrm import ssbrm

__all__ = [
    "read_plink", "GenoMatrix", "ldmat", "read_sumstat", "read_pheno", "read_pedigree",
    "ibrm", "sbrm", "ssbrm", "BlrMod", "plot",
    "DenseLD", "SparseLD", "BlockDiagLD", "TiledSparseLD", "build_tiled_ld",
]


runtime.configure_compile_cache()


def __getattr__(name):
    # `plot` pulls in matplotlib; load it lazily so headless installs
    # without it keep working (the reference keeps CMplot in Imports —
    # R/exports.R:17-19 — we make the equivalent optional instead).
    if name == "plot":
        import importlib

        return importlib.import_module(".plot", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
__version__ = "0.1.0"
