"""chip_smoke.py's phases at tiny shapes on the CPU, kernels in interpret
mode: a dry run of the smoke's plumbing (data, front-ends, comparisons,
meshes) before it goes to the card.  The numbers it prints are CPU numbers.
"""

import jax
import pytest

import chip_smoke as smoke

TINY = dict(
    n_anchor=512, m=1_024, n_mc=256, nchains=16, n_ld=300,
    m_dense=512, n_ped=1_200, n_geno=300, n_phen=600, m_ss=256,
    block=128, niter=12, nburn=6, reps=1, mme_T=128, check_fit=False)


@pytest.fixture
def f32(interpret_kernels):
    """The card runs with x64 off; the test suite turns it on."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.mark.slow
@pytest.mark.parametrize("phase", ["phase1", "phase2", "phase3", "phase4",
                                   "phase5"])
def test_single_card_phase_on_cpu(f32, phase):
    out = getattr(smoke, phase)(TINY)
    if phase != "phase1":
        assert out["path"].endswith("kernels")


@pytest.mark.slow
def test_four_card_phase_on_cpu(f32):
    out = smoke.phase6(TINY)
    assert out["devices"] == "0,1,2,3"
    assert out["snp_turn_agree"] == 1 and out["pipeline_agree"] == 1
