"""Command-line interface for batch runs.

    python -m hibayes_tpu ibrm  --bfile demo --pheno demo.phe --formula "T1~sex" ...
    python -m hibayes_tpu sbrm  --sumstat demo.ma --bfile demo [--chisq 5] ...
    python -m hibayes_tpu ssbrm --bfile demo --pheno demo.phe --ped demo.ped ...
    python -m hibayes_tpu ldmat --bfile demo --out ld.npz [--chisq 5] [--by-chr]

Outputs are written as TSVs under --out-prefix: <prefix>.alpha.tsv (SNP
effects + PIP), <prefix>.gebv.tsv, <prefix>.var.tsv (variance components),
<prefix>.gwas.tsv (window WPPA, when windows requested).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _write_tsv(path, cols: dict):
    keys = list(cols)
    n = len(np.asarray(cols[keys[0]]))
    with open(path, "w") as f:
        f.write("\t".join(keys) + "\n")
        for i in range(n):
            f.write("\t".join(str(np.asarray(cols[k])[i]) for k in keys) + "\n")


def _save_fit(fit, prefix, map_=None):
    alpha_cols = {"alpha": fit.alpha}
    if map_ is not None:
        alpha_cols = {"SNP": map_["SNP"], "Chr": map_["Chr"], "Pos": map_["Pos"],
                      "alpha": fit.alpha}
    if fit.pip is not None:
        alpha_cols["pip"] = fit.pip
    _write_tsv(prefix + ".alpha.tsv", alpha_cols)
    if fit.g is not None:
        _write_tsv(prefix + ".gebv.tsv", fit.g)
    var = {"param": ["mu", "Vg", "Ve", "h2"],
           "value": [fit.mu, fit.Vg, fit.Ve, fit.h2]}
    if fit.Veps is not None:
        var["param"].append("Veps")
        var["value"].append(fit.Veps)
    _write_tsv(prefix + ".var.tsv", var)
    if fit.gwas is not None:
        _write_tsv(prefix + ".gwas.tsv", fit.gwas)
    print(f"written {prefix}.alpha.tsv / .gebv.tsv / .var.tsv"
          + (" / .gwas.tsv" if fit.gwas is not None else ""))


def _save_plots(fit, prefix, map_):
    import matplotlib

    matplotlib.use("Agg")
    from . import plot

    written = []
    if fit.pip is not None and map_ is not None:
        fig, _ = plot.manhattan_pip(fit, map_)
        fig.savefig(prefix + ".pip.png", dpi=150)
        written.append(".pip.png")
    if fit.gwas is not None:
        fig, _ = plot.manhattan_wppa(fit)
        fig.savefig(prefix + ".wppa.png", dpi=150)
        written.append(".wppa.png")
    fig, _ = plot.trace(fit)
    fig.savefig(prefix + ".trace.png", dpi=150)
    written.append(".trace.png")
    print("written " + " / ".join(prefix + w for w in written))


def _common_mcmc_args(p):
    p.add_argument("--method", default="BayesCpi")
    p.add_argument("--niter", type=int, default=None)
    p.add_argument("--nburn", type=int, default=None)
    p.add_argument("--thin", type=int, default=5)
    p.add_argument("--seed", type=int, default=666666)
    p.add_argument("--windsize", type=float, default=None)
    p.add_argument("--windnum", type=int, default=None)
    p.add_argument("--out-prefix", default="fit")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--plots", action="store_true",
                   help="also write <prefix>.{pip,wppa,trace}.png (matplotlib)")


def main(argv=None):
    import hibayes_tpu as ht
    from hibayes_tpu.data.pheno import read_pheno
    from hibayes_tpu.data.pedigree import read_pedigree

    ap = argparse.ArgumentParser(prog="hibayes_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_i = sub.add_parser("ibrm", help="individual-level Bayesian regression")
    p_i.add_argument("--bfile", required=True)
    p_i.add_argument("--pheno", required=True)
    p_i.add_argument("--formula", required=True)
    p_i.add_argument("--nchains", type=int, default=1)
    p_i.add_argument("--shards", type=int, default=1,
                     help="SNP-axis model-parallel shards (devices); the "
                          "genotype/Gram blocks split across their memories")
    p_i.add_argument("--shard-schedule", default="turn",
                     choices=("turn", "pipeline", "concurrent"),
                     help="m-MP sweep schedule: turn (exact), pipeline "
                          "(exact, all shards busy; nchains must be a "
                          "multiple of --shards), concurrent (relaxed; "
                          "validated only for m <~ n)")
    _common_mcmc_args(p_i)

    p_s = sub.add_parser("sbrm", help="summary-level Bayesian regression")
    p_s.add_argument("--sumstat", required=True)
    p_s.add_argument("--bfile", required=True, help="LD reference panel")
    p_s.add_argument("--chisq", type=float, default=None)
    p_s.add_argument("--by-chr", action="store_true")
    p_s.add_argument("--tiled", action="store_true",
                     help="O(nnz) tiled-sparse LD (large m)")
    p_s.add_argument("--tile", type=int, default=128)
    p_s.add_argument("--stripe", type=int, default=4096)
    _common_mcmc_args(p_s)

    p_ss = sub.add_parser("ssbrm", help="single-step Bayesian regression")
    p_ss.add_argument("--bfile", required=True)
    p_ss.add_argument("--pheno", required=True)
    p_ss.add_argument("--formula", required=True)
    p_ss.add_argument("--ped", required=True)
    p_ss.add_argument("--maf", type=float, default=0.01)
    p_ss.add_argument("--impute", default="auto", choices=("auto", "direct", "pcg"),
                      help="imputation operator: pcg = matrix-free scale path")
    _common_mcmc_args(p_ss)

    p_l = sub.add_parser("ldmat", help="LD matrix construction")
    p_l.add_argument("--bfile", required=True)
    p_l.add_argument("--out", required=True)
    p_l.add_argument("--chisq", type=float, default=None)
    p_l.add_argument("--by-chr", action="store_true")
    p_l.add_argument("--tiled", action="store_true",
                     help="stream stripes into an O(nnz) tile store")
    p_l.add_argument("--tile", type=int, default=128)
    p_l.add_argument("--stripe", type=int, default=4096)
    p_l.add_argument("--quiet", action="store_true")

    a = ap.parse_args(argv)

    if a.cmd == "ldmat":
        binr = ht.read_plink(a.bfile)
        ld = ht.ldmat(binr["geno"], map=binr["map"], chisq=a.chisq,
                      ldchr=not a.by_chr, tiled=a.tiled, tile=a.tile,
                      stripe=a.stripe, progress=a.tiled and not a.quiet)
        if a.tiled:
            np.savez(a.out, kind="tiled", tile=ld.tile, m=ld.m,
                     col_idx=ld.col_idx, valid=ld.valid, tiles=ld.tiles,
                     nnz_col=ld.nnz_col)
        elif hasattr(ld, "blocks"):
            np.savez(a.out, kind="blockdiag",
                     **{f"block_{i}": b for i, b in enumerate(ld.blocks)})
        else:
            np.savez(a.out, kind=type(ld).__name__, values=ld.values)
        print(f"LD matrix ({type(ld).__name__}) written to {a.out}")
        return 0

    binr = ht.read_plink(a.bfile)
    verbose = not a.quiet
    common = dict(method=a.method, niter=a.niter, nburn=a.nburn, thin=a.thin,
                  seed=a.seed, verbose=verbose)
    if a.windsize or a.windnum:
        common.update(map=binr["map"], windsize=a.windsize, windnum=a.windnum)

    if a.cmd == "ibrm":
        pheno = read_pheno(a.pheno)
        mesh = None
        if getattr(a, "shards", 1) > 1:
            from .parallel.mesh import make_mesh

            mesh = make_mesh(a.shards, shape=(1, a.shards))
        fit = ht.ibrm(a.formula, data=pheno, M=binr["geno"].values,
                      M_id=binr["fam"][1], checkpoint=a.checkpoint,
                      nchains=a.nchains, mesh=mesh,
                      shard_schedule=getattr(a, "shard_schedule", "turn"),
                      **common)
    elif a.cmd == "sbrm":
        ma = ht.read_sumstat(a.sumstat)
        ld = ht.ldmat(binr["geno"], map=binr["map"], chisq=a.chisq,
                      ldchr=not a.by_chr, tiled=a.tiled, tile=a.tile,
                      stripe=a.stripe)
        fit = ht.sbrm(ma, ld, checkpoint=a.checkpoint, **common)
    else:  # ssbrm
        pheno = read_pheno(a.pheno)
        pid, ps, pd_ = read_pedigree(a.ped)
        fit = ht.ssbrm(a.formula, data=pheno, M=binr["geno"].values,
                       M_id=binr["fam"][1],
                       pedigree={"id": pid, "sire": ps, "dam": pd_},
                       maf=a.maf, impute=a.impute, **common)

    _save_fit(fit, a.out_prefix, map_=binr["map"] if a.cmd != "sbrm" else binr["map"])
    if a.plots:
        _save_plots(fit, a.out_prefix, binr["map"])
    if fit.rhat:
        print("R-hat:", json.dumps({k: round(v, 4) for k, v in fit.rhat.items()
                                    if isinstance(v, float)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
