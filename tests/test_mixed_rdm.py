"""Mixed-estimator per-step density-matrix accumulation options.

Reference semantics: ``pauxy/estimators/mixed.py:76-77`` (one_rdm / two_rdm
input options), ``:226-233`` (weighted per-step accumulation), ``:279-287``
(h5 push). The 'two_rdm' option is the UEG static structure factor S(k)
(``pauxy/estimators/ueg.py:71-82``).
"""

import os
import sys

import numpy as np
import pytest

from pauxy_jax.models import make_hubbard, make_ueg, free_electron_trial
from pauxy_jax.models import rhf_identity_trial
from pauxy_jax.qmc import AFQMC, QMCOpts

REFERENCE = "/root/reference"
HAVE_REF = os.path.isdir(os.path.join(REFERENCE, "pauxy"))
if HAVE_REF:
    sys.path.insert(0, REFERENCE)


@pytest.mark.driver
def test_mixed_one_rdm_hubbard(tmp_path):
    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=20, dt=0.05, nsteps=5, nblocks=4, nstblz=5,
                  npop_control=5, rng_seed=8)
    fn = str(tmp_path / "rdm.h5")
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": 1,
                                            "one_rdm": True}},
               filename=fn)
    rows = af.run()
    if not HAVE_REF:
        pytest.skip("no reference tooling")
    from pauxy.analysis.extraction import extract_data

    rdms = extract_data(fn, "basic", "one_rdm", raw=True)
    assert rdms.shape == (qmc.nblocks, 2, ham.nbasis, ham.nbasis)
    # Mixed 1-RDM traces must equal the particle numbers per spin; the
    # per-spin E1B recomputed from the RDM must match the energy column.
    t = np.asarray(ham.T)
    for b in range(qmc.nblocks):
        g = rdms[b]
        assert np.trace(g[0]).real == pytest.approx(3.0, abs=1e-4)
        assert np.trace(g[1]).real == pytest.approx(3.0, abs=1e-4)
        e1b_from_rdm = np.sum(t[0] * g[0] + t[1] * g[1]).real
        assert e1b_from_rdm == pytest.approx(rows[b, 6].real, abs=1e-3)


@pytest.mark.driver
def test_mixed_two_rdm_structure_factor_ueg(tmp_path):
    ham = make_ueg(nup=2, ndown=2, rs=1.0, ecut=0.5)
    trial = rhf_identity_trial(ham)
    qmc = QMCOpts(nwalkers=12, dt=0.01, nsteps=5, nblocks=3, nstblz=5,
                  npop_control=5, rng_seed=8)
    fn = str(tmp_path / "sk.h5")
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": 1,
                                            "one_rdm": True,
                                            "two_rdm": "structure_factor"}},
               filename=fn)
    rows = af.run()
    if not HAVE_REF:
        pytest.skip("no reference tooling")
    from pauxy.analysis.extraction import extract_data

    sk = extract_data(fn, "basic", "two_rdm", raw=True)
    assert sk.shape == (qmc.nblocks, 2, 2, ham.nq)
    vq = np.asarray(ham.vqvec)
    fac = 1.0 / (2.0 * ham.vol)
    for b in range(qmc.nblocks):
        # E2Body = 1/(2 vol) sum_q v(q) sum_ss' two_rdm[s,s',q]
        # (pauxy/estimators/ueg.py:73-85).
        pe_from_sk = fac * np.sum(vq * sk[b].sum(axis=(0, 1))).real
        assert pe_from_sk == pytest.approx(rows[b, 7].real, abs=1e-4)


@pytest.mark.unit
def test_two_rdm_rejected_off_ueg():
    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    from pauxy_jax.estimators import mixed as mx

    with pytest.raises(NotImplementedError):
        mx.dms_size(ham, False, "structure_factor")
