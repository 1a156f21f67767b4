"""The reference's 3x3 Hubbard tutorial anchors, reproduced statistically.

Reference tutorial (docs/source/tutorials/calcs/hubbard/input.json +
*.out): 3x3 Hubbard U=4, (3,3), twist [0.01, -0.02], free-electron trial,
DISCRETE Hirsch CPMC, dt=0.05, published numbers:

  mixed ETotal = -9.667367  +/- 0.006009   (basic.out:1-2)
  BP ETotal    = -10.172595 +/- 0.221067   (back_propagated.out:1-2,
                                            nback_prop=40)
  ITCF G>up00(tau=0) = 0.662088 +/- 0.043912, decaying to ~0.14 at
  tau=0.9 (itcf.out:1-20)

One run covers all three (RNG streams differ from the reference by
design; agreement is at combined-sigma level).
"""

import h5py
import numpy as np
import pytest

from pauxy_jax.models import make_hubbard, free_electron_trial
from pauxy_jax.qmc import AFQMC, QMCOpts

pytestmark = pytest.mark.driver


def test_3x3_tutorial_anchors(tmp_path):
    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3,
                       ktwist=[0.01, -0.02])
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=100, dt=0.05, nsteps=10, nblocks=300, nstblz=5,
                  npop_control=10, rng_seed=8)
    af = AFQMC(
        ham, trial, qmc,
        propagator_options={"hubbard_stratonovich": "discrete"},
        estimator_options={
            "mixed": {"energy_eval_freq": 10},
            "back_propagation": {"tau_bp": 2.0, "evaluate_energy": True},
            "itcf": {"tau_max": 2.0, "stable": True},
        },
        filename=str(tmp_path / "tut.h5"),
    )
    rows = af.run()

    # --- mixed energy (basic.out) -------------------------------------
    et = rows[40:, 5].real
    b = et[: len(et) // 10 * 10].reshape(-1, 10).mean(axis=1)
    se = b.std(ddof=1) / len(b) ** 0.5
    comb = np.hypot(se, 0.006009)
    assert abs(et.mean() - (-9.667367)) < 4 * comb, (et.mean(), se)

    with h5py.File(str(tmp_path / "tut.h5"), "r") as fh5:
        bp = np.stack([
            fh5[f"back_propagated/energies_40/{k}"][:]
            for k in sorted(fh5["back_propagated/energies_40"],
                            key=lambda s: int(s))
        ])
        ig = fh5["itcf/real_space_greens_function"]
        spgf = np.stack([ig[k][:]
                         for k in sorted(ig, key=lambda s: int(s))])

    # --- back-propagated energy (back_propagated.out) ------------------
    ebp = bp[4:, 0].real
    sebp = ebp.std(ddof=1) / len(ebp) ** 0.5
    comb = np.hypot(sebp, 0.221067)
    assert abs(ebp.mean() - (-10.172595)) < 4 * comb, (ebp.mean(), sebp)

    # --- ITCF (itcf.out): G^>_{up,00} at tau = 0 and tau = 0.9 ---------
    # tau_max=2.0 at 10 steps/block completes a measurement every 4th
    # block; the other blocks are zero-filled -> select live rows.
    live = spgf[np.abs(spgf[:, 0, 0, 0, 0, 0]) > 1e-12]
    assert len(live) >= 40
    g0 = live[4:, 0, 0, 0, 0, 0]
    se0 = g0.std(ddof=1) / len(g0) ** 0.5
    comb = np.hypot(se0, 0.043912)
    assert abs(g0.mean() - 0.662088) < 4 * comb, (g0.mean(), se0)
    g9 = live[4:, 18, 0, 0, 0, 0]          # tau = 0.9
    assert abs(g9.mean() - 0.14) < 0.05, g9.mean()
