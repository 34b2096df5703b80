"""Pedigree kernels + single-step model tests."""

import numpy as np
import pytest

import hibayes_tpu as ht
from hibayes_tpu.data.pedigree import make_ainv, make_ped, read_pedigree, solve_a_ng
from hibayes_tpu.model.ssbrm import ssbrm

DEMO = "/root/reference/inst/extdata/demo"


# ---------------------------------------------------------------- pedigree
def test_make_ped_orders_parents_first():
    ids = np.array(["c", "a", "b"])
    sires = np.array(["a", "0", "0"])
    dams = np.array(["b", "0", "0"])
    out_ids, s, d = make_ped(ids, sires, dams)
    pos = {v: i for i, v in enumerate(out_ids)}
    assert pos["a"] < pos["c"] and pos["b"] < pos["c"]
    # c's parents point at a and b (1-based)
    ci = pos["c"]
    assert out_ids[s[ci] - 1] == "a"
    assert out_ids[d[ci] - 1] == "b"


def test_make_ped_unlisted_parent_becomes_founder():
    ids = np.array(["x"])
    sires = np.array(["p"])
    dams = np.array(["NA"])
    out_ids, s, d = make_ped(ids, sires, dams)
    assert set(out_ids) == {"x", "p"}
    pos = {v: i for i, v in enumerate(out_ids)}
    assert pos["p"] < pos["x"]
    assert d[pos["x"]] == 0  # unknown dam


def test_make_ainv_trio_matches_analytic():
    """Known A-inverse for a trio (sire s, dam d, offspring o):
    diag: s,d = 1.5, o = 2; s-d = 0.5; o-parents = -1."""
    ids = np.array(["s", "d", "o"])
    sires = np.array(["0", "0", "s"])
    dams = np.array(["0", "0", "d"])
    out_ids, si, di = make_ped(ids, sires, dams)
    A = make_ainv(si, di).todense()
    pos = {v: i for i, v in enumerate(out_ids)}
    s_, d_, o_ = pos["s"], pos["d"], pos["o"]
    assert A[s_, s_] == 1.5 and A[d_, d_] == 1.5 and A[o_, o_] == 2.0
    assert A[s_, d_] == 0.5 and A[o_, s_] == -1.0 and A[o_, d_] == -1.0


def test_make_ainv_one_parent_correct_vs_compat():
    ids = np.array(["s", "o"])
    sires = np.array(["0", "s"])
    dams = np.array(["0", "0"])
    _, si, di = make_ped(ids, sires, dams)
    A = make_ainv(si, di).todense()
    # correct Henderson single-parent rules
    np.testing.assert_allclose(A[1, 1], 4.0 / 3.0)
    np.testing.assert_allclose(A[0, 1], -2.0 / 3.0)
    np.testing.assert_allclose(A[0, 0], 1.0 + 1.0 / 3.0)
    # compat mode replicates the reference's integer-division quirk
    # (src/rm.cpp:195-203: 4/3 -> 1, 2/3 and 1/3 -> 0)
    Ac = make_ainv(si, di, compat_hibayes=True).todense()
    np.testing.assert_allclose(Ac[1, 1], 1.0)
    np.testing.assert_allclose(Ac[0, 1], 0.0)
    np.testing.assert_allclose(Ac[0, 0], 1.0)


def test_ainv_inverts_relationship_matrix():
    """A-inverse from Henderson rules must actually invert the numerator
    relationship matrix A built by the tabular method (no inbreeding)."""
    ids = np.array(["a", "b", "c", "d", "e"])
    sires = np.array(["0", "0", "a", "a", "c"])
    dams = np.array(["0", "0", "b", "b", "d"])
    out_ids, si, di = make_ped(ids, sires, dams)
    n = len(out_ids)
    # tabular A
    A = np.zeros((n, n))
    for i in range(n):
        s_, d_ = si[i] - 1, di[i] - 1
        for j in range(i):
            a_js = A[j, s_] if s_ >= 0 else 0.0
            a_jd = A[j, d_] if d_ >= 0 else 0.0
            A[i, j] = A[j, i] = 0.5 * (a_js + a_jd)
        inb = 0.5 * A[s_, d_] if (s_ >= 0 and d_ >= 0) else 0.0
        A[i, i] = 1.0 + inb
    Ainv = np.linalg.inv(A)
    H = np.asarray(make_ainv(si, di).todense())
    # Henderson's rules ignore inbreeding; with one inbred individual (e)
    # allow loose agreement on e's entries, exact elsewhere
    np.testing.assert_allclose(H[:4, :4], Ainv[:4, :4], atol=0.35)


def test_solve_a_ng():
    rng = np.random.default_rng(0)
    import scipy.sparse as sp

    Ann = sp.csc_matrix(np.diag(rng.uniform(1, 2, 5)) + 0.1 * np.eye(5))
    Ang = sp.csc_matrix(rng.normal(size=(5, 3)))
    X = solve_a_ng(Ann, Ang)
    np.testing.assert_allclose(Ann @ X, -np.asarray(Ang.todense()), atol=1e-10)


# -------------------------------------------------------------------- ssbrm
@pytest.fixture(scope="module")
def demo():
    bin_ = ht.read_plink(DEMO)
    pheno = {}
    with open(DEMO + ".phe") as f:
        header = f.readline().split()
        rows = [line.split() for line in f if line.strip()]
    for i, h in enumerate(header):
        col = np.array([r[i] for r in rows])
        try:
            col = col.astype(np.float64)
        except ValueError:
            pass
        pheno[h] = col
    ped = read_pedigree(DEMO + ".ped")
    return bin_, pheno, ped


@pytest.mark.slow
def test_ssbrm_demo(demo):
    bin_, pheno, (pid, ps, pd_) = demo
    fit = ssbrm(
        "T1~1", data=pheno, M=bin_["geno"].values, M_id=bin_["fam"][1],
        pedigree={"id": pid, "sire": ps, "dam": pd_},
        method="BayesCpi", niter=1000, nburn=600, thin=5, verbose=False,
    )
    # GEBV for every pedigree id (genotyped + non-genotyped)
    assert len(fit.g["id"]) > 600
    assert np.isfinite(fit.g["gebv"]).all()
    assert fit.Veps is not None and fit.Veps > 0
    assert fit.J is not None
    assert fit.epsilon is not None
    assert 0 < fit.h2 < 1
    # phenotyped individuals WITHOUT genotype contribute via imputation
    assert len(fit.e["id"]) == 500  # all 500 phenotyped ids are in pedigree


@pytest.mark.slow
def test_ssbrm_multichain(demo):
    bin_, pheno, (pid, ps, pd_) = demo
    fit = ssbrm(
        "T1~sex+(1|loc)", data=pheno, M=bin_["geno"].values, M_id=bin_["fam"][1],
        pedigree={"id": pid, "sire": ps, "dam": pd_},
        method="BayesCpi", niter=300, nburn=150, verbose=False, nchains=2,
    )
    assert fit.rhat is not None and "Ve" in fit.rhat
    assert np.isfinite(fit.g["gebv"]).all()
    # 2 chains x 15 records flattened
    assert fit.MCMCsamples["Vg"].shape[0] == 2 * (300 - 150) // 5


def test_ssbrm_synthetic_prediction():
    """Non-genotyped relatives' GEBV should correlate with their true
    breeding values through the pedigree."""
    rng = np.random.default_rng(21)
    n_founders, m = 120, 300
    Mf = rng.binomial(2, rng.uniform(0.2, 0.5, m), size=(n_founders, m)).astype(float)
    # offspring = average of two random parents + mendelian noise (crude)
    n_off = 120
    pairs = rng.integers(0, n_founders, size=(n_off, 2))
    Mo = np.zeros((n_off, m))
    for k, (a, b) in enumerate(pairs):
        Mo[k] = np.round((Mf[a] + Mf[b]) / 2 + rng.normal(0, 0.3, m)).clip(0, 2)
    beta = np.zeros(m)
    beta[rng.choice(m, 20, replace=False)] = rng.normal(0, 0.5, 20)
    g_all = np.concatenate([Mf @ beta, Mo @ beta])
    y_all = g_all + rng.normal(0, g_all.std(), 2 * n_founders)

    ids = np.array([f"F{i}" for i in range(n_founders)] + [f"O{i}" for i in range(n_off)])
    ped_id = ids
    ped_s = np.array(["0"] * n_founders + [f"F{a}" for a, _ in pairs])
    ped_d = np.array(["0"] * n_founders + [f"F{b}" for _, b in pairs])
    # only founders genotyped; everyone phenotyped
    data = {"id": ids, "y": y_all}
    fit = ssbrm(
        "y~1", data=data, M=Mf, M_id=ids[:n_founders],
        pedigree={"id": ped_id, "sire": ped_s, "dam": ped_d},
        method="BayesCpi", niter=1500, nburn=900, verbose=False,
    )
    gmap = {i: v for i, v in zip(fit.g["id"], fit.g["gebv"])}
    pred_off = np.array([gmap[f"O{i}"] for i in range(n_off)])
    corr = np.corrcoef(pred_off, g_all[n_founders:])[0, 1]
    assert corr > 0.35, f"offspring GEBV corr too low: {corr}"


def test_ssbrm_demo_golden_vs_reference_readme(demo):
    """Statistical parity with the reference README's published ssbrm fit
    (README.md:345-384): `ssbrm(T1 ~ sex + bwt + (1|dam), method="BayesR",
    Pi=c(.95,.02,.02,.01), fold=c(0,1e-4,1e-3,1e-2))` on the demo data prints
    Vg=65.52 (SD 10.37), h2=0.412 (SD 0.056), Veps=56.57 (SD 21.88),
    Ve=88.44 (SD 9.87), Vdam=4.80 (SD 4.53), sexMale=-20.84 (SD 1.17),
    bwt=0.4919 (SD 0.831), J=-40.82 (SD 15.28), with 500 obs, 250 dam
    levels, 1000 markers, 1500 predicted individuals.  Posterior means are
    checked within 3 published posterior SDs (RNG families differ)."""
    bin_, pheno, (pid, ps, pd_) = demo
    fit = ssbrm(
        "T1~sex+bwt+(1|dam)", data=pheno, M=bin_["geno"].values,
        M_id=bin_["fam"][1], pedigree={"id": pid, "sire": ps, "dam": pd_},
        method="BayesR", Pi=[0.95, 0.02, 0.02, 0.01],
        fold=[0.0, 1e-4, 1e-3, 1e-2], niter=3000, nburn=1500, thin=5,
        verbose=False, seed=666666,
    )
    # structure of the published fit
    assert len(fit.e["id"]) == 500
    assert len(fit.r["Levels"]) == 250          # dam group levels
    assert fit.alpha.shape == (1000,)
    assert len(fit.g["id"]) == 1500             # all pedigree ids predicted
    assert fit.beta_names == ["sexMale", "bwt"]
    # posterior means within 3 published posterior SDs
    assert abs(fit.Vg - 65.5210) < 3 * 10.371
    assert abs(fit.h2 - 0.4120) < 3 * 0.056
    assert abs(fit.Veps - 56.5732) < 3 * 21.883
    assert abs(fit.Ve - 88.443) < 3 * 9.872
    assert abs(fit.Vr[0] - 4.803) < 3 * 4.527   # dam variance
    assert abs(fit.beta[0] - (-20.8402)) < 3 * 1.170   # sexMale
    assert abs(fit.beta[1] - 0.4919) < 3 * 0.831       # bwt
    # J (J_i = -1 for genotyped ids) is nearly collinear with the intercept,
    # so mu and J individually mix slowly; only the identified combination
    # mu - J (the genotyped-individual level) is comparable across chains.
    # Published: mu=3.0881 (SD 15.066), J=-40.8167 (SD 15.282).
    tol = 3 * np.hypot(15.066, 15.282)
    assert abs((fit.mu - fit.J) - (3.0881 + 40.8167)) < tol
    # BayesR mixture proportions (published SDs are wide)
    for k, (mean, sd) in enumerate([(0.1516, 0.106), (0.1856, 0.127),
                                    (0.1671, 0.144), (0.4957, 0.195)]):
        assert abs(fit.pi[k] - mean) < 3 * sd + 0.05


# ---------------------------------------------------- scale path (PCG/tiled)
def _random_pedigree(nfound, nkid, seed=0):
    rng = np.random.default_rng(seed)
    ids = [f"F{i}" for i in range(nfound)]
    sires = ["0"] * nfound
    dams = ["0"] * nfound
    for k in range(nkid):
        ids.append(f"K{k}")
        sires.append(ids[rng.integers(0, len(ids) - 1)])
        dams.append(ids[rng.integers(0, len(ids) - 1)])
    return np.array(ids), np.array(sires), np.array(dams)


def test_imputation_operator_matches_dense_solve():
    from hibayes_tpu.data.pedigree import ImputationOperator, make_ainv, make_ped

    rng = np.random.default_rng(3)
    ids, sires, dams = _random_pedigree(60, 400, seed=1)
    ped_ids, s_idx, d_idx = make_ped(ids, sires, dams)
    Ai = make_ainv(s_idx, d_idx)
    n = len(ped_ids)
    g_indx = rng.choice(n, 120, replace=False)
    ng = np.setdiff1d(np.arange(n), g_indx)
    Ai_nn = Ai[np.ix_(ng, ng)]
    Ai_ng = Ai[np.ix_(ng, g_indx)]
    A_dense = solve_a_ng(Ai_nn, Ai_ng)
    op = ImputationOperator(Ai_nn, Ai_ng)
    V = rng.normal(size=(len(g_indx), 7))
    np.testing.assert_allclose(op.apply(V), A_dense @ V, atol=1e-6)
    M = rng.binomial(2, 0.3, (len(g_indx), 50)).astype(np.float64)
    rows = np.sort(rng.choice(len(ng), 40, replace=False))
    np.testing.assert_allclose(
        op.impute(M, rows_needed=rows, chunk_cols=16), (A_dense @ M)[rows],
        atol=1e-6,
    )


def test_blocked_mme_gibbs_sparse_matches_dense():
    import jax.numpy as jnp
    import scipy.sparse as sp

    from hibayes_tpu.data.pedigree import make_ainv, make_ped, rcm_permutation
    from hibayes_tpu.engine.gibbs import (
        _build_epsl_sparse,
        blocked_mme_gibbs,
        blocked_mme_gibbs_sparse,
    )

    rng = np.random.default_rng(5)
    ids, sires, dams = _random_pedigree(40, 300, seed=2)
    _, s_idx, d_idx = make_ped(ids, sires, dams)
    Ai = sp.csr_matrix(make_ainv(s_idx, d_idx))
    perm = rcm_permutation(Ai)
    A = Ai[perm][:, perm]
    q = A.shape[0]
    T = 16
    sp_obj, qe_pad = _build_epsl_sparse(A, T, jnp.float64)
    counts = np.zeros(qe_pad)
    counts[:q] = rng.integers(0, 3, q).astype(float)
    b = np.zeros(qe_pad)
    b[:q] = rng.normal(size=q)
    z = np.zeros(qe_pad)
    z[:q] = rng.normal(size=q)
    ve, scale = 1.3, 0.7
    A_pad = np.zeros((qe_pad, qe_pad))
    A_pad[:q, :q] = A.toarray()
    LHS = A_pad * scale + np.diag(counts)
    xt, Ae = blocked_mme_gibbs_sparse(
        sp_obj, jnp.asarray(counts), jnp.asarray(scale), jnp.zeros(qe_pad),
        jnp.asarray(b), jnp.asarray(ve), jnp.asarray(z),
    )
    xd = blocked_mme_gibbs(
        jnp.asarray(LHS), jnp.asarray(np.diag(LHS)), jnp.zeros(qe_pad),
        jnp.asarray(b), jnp.asarray(ve), jnp.asarray(z), T,
    )
    np.testing.assert_allclose(np.asarray(xt)[:q], np.asarray(xd)[:q], atol=1e-9)
    np.testing.assert_allclose(np.asarray(Ae), A_pad @ np.asarray(xt), atol=1e-9)
    assert (np.asarray(xt)[q:] == 0).all()  # pad sites frozen
    # O(nnz) storage: the padded triplet store stays within ~3x of nnz
    stored = sp_obj.blk_vals.size
    assert stored < 4 * A.nnz + sp_obj.diag_blocks.shape[0] * T


def test_blocked_mme_gibbs_sparse_kernel_matches_scan(interpret_kernels):
    """The Pallas-Triton MME block-draw kernel (interpret mode) draws the
    same chain as the XLA per-site scan (f32, association-order
    tolerance)."""
    import jax.numpy as jnp
    import scipy.sparse as sp

    from hibayes_tpu.data.pedigree import make_ainv, make_ped, rcm_permutation
    from hibayes_tpu.engine.gibbs import (
        _build_epsl_sparse,
        blocked_mme_gibbs_sparse,
    )

    rng = np.random.default_rng(9)
    ids, sires, dams = _random_pedigree(40, 300, seed=3)
    _, s_idx, d_idx = make_ped(ids, sires, dams)
    Ai = sp.csr_matrix(make_ainv(s_idx, d_idx))
    perm = rcm_permutation(Ai)
    A = Ai[perm][:, perm]
    q = A.shape[0]
    T = 16
    sp_obj, qe_pad = _build_epsl_sparse(A, T, jnp.float32)
    counts = np.zeros(qe_pad, np.float32)
    counts[:q] = rng.integers(0, 3, q).astype(np.float32)
    b = np.zeros(qe_pad, np.float32)
    b[:q] = rng.normal(size=q)
    z = np.zeros(qe_pad, np.float32)
    z[:q] = rng.normal(size=q)
    args = (sp_obj, jnp.asarray(counts), jnp.float32(0.7),
            jnp.zeros(qe_pad, jnp.float32), jnp.asarray(b), jnp.float32(1.3),
            jnp.asarray(z))
    x_scan, Ae_scan = blocked_mme_gibbs_sparse(*args, use_pallas=False)
    x_kern, Ae_kern = blocked_mme_gibbs_sparse(*args, use_pallas=True)
    scale = np.abs(np.asarray(x_scan)).max() + 1e-12
    np.testing.assert_allclose(np.asarray(x_kern), np.asarray(x_scan),
                               rtol=0, atol=1e-4 * scale)
    assert (np.asarray(x_kern)[q:] == 0).all()


@pytest.mark.slow
def test_ssbrm_pcg_path_statistically_matches_direct(demo):
    bin_, pheno, (pid, ps, pd_) = demo
    kw = dict(
        data=pheno, M=bin_["geno"].values, M_id=bin_["fam"][1],
        pedigree={"id": pid, "sire": ps, "dam": pd_},
        method="BayesCpi", niter=2000, nburn=1200, thin=5,
        verbose=False, seed=11,
    )
    fd = ssbrm("T1~sex+(1|loc)", impute="direct", **kw)
    fp = ssbrm("T1~sex+(1|loc)", impute="pcg", **kw)
    assert np.isfinite(fp.g["gebv"]).all()
    np.testing.assert_allclose(fp.Vg, fd.Vg, rtol=0.25)
    np.testing.assert_allclose(fp.Ve, fd.Ve, rtol=0.25)
    np.testing.assert_allclose(fp.h2, fd.h2, atol=0.08)
    gd = dict(zip(fd.g["id"], fd.g["gebv"]))
    gp = dict(zip(fp.g["id"], fp.g["gebv"]))
    ids = list(gd)
    corr = np.corrcoef([gd[i] for i in ids], [gp[i] for i in ids])[0, 1]
    assert corr > 0.9, f"GEBV corr {corr}"


def test_ssbrm_scale_synthetic_no_dense_operator(monkeypatch):
    """The PCG scale path must never build the dense (n_ng, n_g) operator or
    the dense (qe, qe) epsilon matrix (VERDICT task: 100k-pedigree class
    problems; sized down for CI runtime)."""
    import hibayes_tpu.model.ssbrm as SS

    def boom(*a, **k):
        raise AssertionError("dense solve_a_ng called on the scale path")

    monkeypatch.setattr(SS, "solve_a_ng", boom)

    rng = np.random.default_rng(7)
    ids, sires, dams = _random_pedigree(500, 7500, seed=4)  # 8000 ids
    n_g, m = 1500, 64
    geno_ids = rng.choice(ids, n_g, replace=False)
    M = rng.binomial(2, 0.35, (n_g, m)).astype(np.int8)
    # phenotype 600 genotyped + 600 non-genotyped ids
    others = np.setdiff1d(ids, geno_ids)
    phe_ids = np.concatenate([
        rng.choice(geno_ids, 600, replace=False),
        rng.choice(others, 600, replace=False),
    ])
    y = rng.normal(0, 1, len(phe_ids))
    fit = SS.ssbrm(
        "y~1", data={"id": phe_ids, "y": y}, M=M, M_id=geno_ids,
        pedigree={"id": ids, "sire": sires, "dam": dams},
        method="BayesCpi", niter=20, nburn=10, thin=5,
        verbose=False, impute="pcg", chunk_cols=32,
    )
    assert np.isfinite(fit.g["gebv"]).all()
    assert len(fit.g["id"]) == len(ids)
    assert fit.Veps is not None and np.isfinite(fit.Veps)


def test_ssbrm_ne0_large_n_row_padding():
    """ne == 0 (every phenotyped individual genotyped) drops the epsilon args
    at n > 4096: the GibbsSpec's n must match the rows of the prepared data
    or the trace crashes on a shape mismatch."""
    rng = np.random.default_rng(11)
    ids, sires, dams = _random_pedigree(200, 300, seed=9)  # 500 pedigree ids
    n_g, m = 5000, 64
    extra_geno = np.array([f"G{i}" for i in range(n_g - 100)])
    geno_ids = np.concatenate([rng.choice(ids, 100, replace=False), extra_geno])
    M = rng.binomial(2, 0.35, (n_g, m)).astype(np.int8)
    y = rng.normal(0, 1, n_g)
    with pytest.warns(UserWarning, match="imputation errors"):
        fit = ssbrm(
            "y~1", data={"id": geno_ids, "y": y}, M=M, M_id=geno_ids,
            pedigree={"id": ids, "sire": sires, "dam": dams},
            method="BayesCpi", niter=20, nburn=10, thin=5, verbose=False,
        )
    assert np.isfinite(fit.Vg) and np.isfinite(fit.Ve)
    assert np.isfinite(fit.g["gebv"]).all()
