"""Lanes-layout fast block vs the generic fused block: same physics.

The fast path consumes the identical RNG stream and follows the identical
step schedule, so every output row must agree to float tolerance (x64 on
CPU -> very tight).
"""

import os

import numpy as np
import pytest

from pauxy_jax.models import make_hubbard, free_electron_trial
from pauxy_jax.qmc import AFQMC, QMCOpts


def run(tmp_path, tag, fast: bool, **kw):
    os.environ["PAUXY_FAST"] = "1" if fast else "0"
    try:
        ham = make_hubbard(nup=kw.get("nup", 7), ndown=kw.get("ndown", 7),
                           U=4.0, nx=4, ny=4, ktwist=kw.get("ktwist"))
        trial = free_electron_trial(ham)
        qmc = QMCOpts(
            nwalkers=kw.get("nwalkers", 24), dt=0.01, nsteps=10, nblocks=4,
            nstblz=5, npop_control=kw.get("npop_control", 2), rng_seed=8,
            pop_control_method=kw.get("pop_method", "comb"),
        )
        af = AFQMC(
            ham, trial, qmc,
            propagator_options=kw.get("popts"),
            estimator_options={"mixed": {"energy_eval_freq":
                                         kw.get("eef", 1)}},
            filename=str(tmp_path / f"{tag}.h5"),
        )
        if fast:
            assert af.use_fast_block, "fast path should be eligible here"
        rows = af.run()
        return rows
    finally:
        os.environ.pop("PAUXY_FAST", None)


@pytest.mark.parametrize("pop_method", ["comb", "pair_branch"])
def test_fast_block_matches_generic(tmp_path, pop_method):
    r1 = run(tmp_path, f"gen_{pop_method}", False, pop_method=pop_method)
    r2 = run(tmp_path, f"fast_{pop_method}", True, pop_method=pop_method)
    np.testing.assert_allclose(r1[:, 1:10].real, r2[:, 1:10].real,
                               rtol=1e-8, atol=1e-10)


def test_fast_block_matches_generic_twist_spin(tmp_path):
    """Complex hopping (twist) + spin decomposition + unequal spins."""
    kw = dict(ktwist=[0.02, -0.01], nup=7, ndown=6,
              popts={"charge_decomposition": False})
    r1 = run(tmp_path, "gen_tw", False, **kw)
    r2 = run(tmp_path, "fast_tw", True, **kw)
    np.testing.assert_allclose(r1[:, 1:10].real, r2[:, 1:10].real,
                               rtol=1e-8, atol=1e-10)


def test_fast_block_matches_generic_no_force_bias(tmp_path):
    kw = dict(popts={"force_bias": False}, eef=2, npop_control=3)
    r1 = run(tmp_path, "gen_nfb", False, **kw)
    r2 = run(tmp_path, "fast_nfb", True, **kw)
    np.testing.assert_allclose(r1[:, 1:10].real, r2[:, 1:10].real,
                               rtol=1e-8, atol=1e-10)


def test_fast_block_ineligible_paths_fall_back(tmp_path):
    """BP on -> generic block (fast path silently disabled)."""
    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=8, dt=0.01, nsteps=10, nblocks=2, nstblz=5,
                  npop_control=2, rng_seed=8)
    af = AFQMC(
        ham, trial, qmc,
        estimator_options={
            "mixed": {"energy_eval_freq": 1},
            "back_propagation": {"tau_bp": 0.05},
        },
        filename=str(tmp_path / "bp.h5"),
    )
    assert not af.use_fast_block
    rows = af.run()
    assert np.isfinite(rows.real).all()


@pytest.mark.unit
@pytest.mark.parametrize("m,n", [(16, 7), (36, 18), (64, 24)])
def test_greens_lanes_matches_numpy(m, n):
    """The unrolled walker-last Green's function of the fast block matches
    numpy's logdet and S^-1 phi^T from the 4x4 lattice up to 8x8."""
    import jax.numpy as jnp

    from pauxy_jax.qmc import hubbard_fast as hf

    rng = np.random.default_rng(5)
    w = 8
    psi = rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n))
    phi = 0.3 * (rng.normal(size=(m, n, w))
                 + 1j * rng.normal(size=(m, n, w))) + psi[:, :, None]
    ld, ght, diag = hf._greens_lanes(jnp.asarray(psi), jnp.asarray(phi))
    s = np.einsum("mnw,mk->wnk", phi, psi.conj())
    sign, ldref = np.linalg.slogdet(s)
    gh_ref = np.einsum("wni,miw->wnm", np.linalg.inv(s), phi)
    gh = np.transpose(np.asarray(ght), (2, 1, 0))
    np.testing.assert_allclose(np.exp(np.asarray(ld)), sign * np.exp(ldref),
                               rtol=1e-9)
    np.testing.assert_allclose(gh, gh_ref, atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(diag).T, np.einsum("mi,wim->wm", psi.conj(), gh_ref),
        atol=1e-9)


@pytest.mark.unit
def test_eligible_classifies_every_propagator_option():
    """Drift catcher for the fast-path gate: every config field of
    Continuous / HubbardContinuous must be classified here as either
    read identically by the lanes block or gated by hubbard_fast.eligible.
    A new propagator option fails this test until its author decides
    which — preventing the fast block from silently running different
    physics than qmc/afqmc.run_block."""
    import dataclasses

    from pauxy_jax.propagation.continuous import Continuous
    from pauxy_jax.propagation.hubbard import HubbardContinuous

    continuous_classified = {
        "inner",            # isinstance(HubbardContinuous) gate
        "dt",               # read identically by both block programs
        "free_projection",  # gated: fast path requires False
        "hybrid",           # gated: fast path requires True
        "force_bias",       # supported: lanes force-bias branch
        "stochastic_ri",    # gated: fast path requires False
        "ri_nsamples",      # only meaningful with stochastic_ri
    }
    fields = {f.name for f in dataclasses.fields(Continuous)}
    assert fields == continuous_classified, (
        "Continuous gained/lost config fields; classify them in "
        "hubbard_fast.eligible (gate or support) and update this test: "
        f"{fields ^ continuous_classified}"
    )

    hubbard_classified = {
        "BH1",       # read by the lanes one-body half-step
        "mf_shift",  # read by the lanes force-bias/cmf terms
        "dt",        # read identically
        "U",         # read by the lanes VHS build
        "charge",    # supported: both decompositions in the lanes block
    }
    hfields = {f.name for f in dataclasses.fields(HubbardContinuous)}
    assert hfields == hubbard_classified, (
        "HubbardContinuous gained/lost config fields; classify them for "
        "the lanes fast block and update this test: "
        f"{hfields ^ hubbard_classified}"
    )
