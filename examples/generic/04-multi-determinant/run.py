"""Multi-determinant trial for stretched H4: file-based NOMSD workflow.

Counterpart of the reference's ``examples/generic/02-multi_determinant``:
build a small multi-determinant expansion, write it in the QMCPACK HDF5
wavefunction layout, and point the driver at it via ``trial.filename``.
Here the expansion is the spin-restored pair {UHF det, its alpha<->beta
flip} — two determinants with equal weight — which removes most of the
single-determinant UHF spin-contamination bias at stretched geometry.

    python examples/generic/04-multi-determinant/run.py   # ~2 min on CPU
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.abspath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "..")))

import jax

if "--gpu" not in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np

from pauxy_jax.estimators import ci
from pauxy_jax.models.trial import trial_from_orbitals
from pauxy_jax.qmc import AFQMC, QMCOpts
from pauxy_jax.qmc.calc import get_trial_wavefunction
from pauxy_jax.utils.sgto import hydrogen_chain_afqmc
from pauxy_jax.utils.wavefunction import write_qmcpack_wfn

R = 2.4          # stretched: strong correlation, MSD matters
NELEC = (2, 2)


def run(ham, trial, tag):
    qmc = QMCOpts(nwalkers=128, dt=0.01, nsteps=10, nblocks=120, nstblz=5,
                  npop_control=5, rng_seed=8)
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": 1}},
               filename=f"h4_{tag}.h5")
    rows = af.run()
    et = rows[60:, 5].real
    return et.mean(), et.std(ddof=1) / len(et) ** 0.5


def main():
    ham, psi_uhf, e_uhf = hydrogen_chain_afqmc(4, R, nelec=NELEC)
    na, nb = NELEC

    # Two-determinant NOMSD: the UHF determinant and its spin-flip.
    flip = np.concatenate([psi_uhf[:, na:], psi_uhf[:, :na]], axis=1)
    wfn = np.stack([psi_uhf, flip]).astype(np.complex128)
    coeffs = np.array([1.0, 1.0], dtype=np.complex128) / np.sqrt(2)
    with tempfile.TemporaryDirectory() as tmp:
        wfn_file = os.path.join(tmp, "wfn.h5")
        write_qmcpack_wfn(wfn_file, coeffs, wfn, NELEC)
        # The same file-based path the JSON input uses:
        #   "trial": {"name": "MultiSlater", "filename": "wfn.h5"}
        msd = get_trial_wavefunction(ham, {"name": "MultiSlater",
                                           "filename": wfn_file})
        e_sd, err_sd = run(ham, trial_from_orbitals(ham, psi_uhf), "sd")
        e_msd, err_msd = run(ham, msd, "msd")

    ev, _, _ = ci.simple_fci(ham)
    print(f"UHF                  : {e_uhf:12.6f} Ha")
    print(f"AFQMC single det     : {e_sd:12.6f} +/- {err_sd:.6f} Ha")
    print(f"AFQMC 2-det (NOMSD)  : {e_msd:12.6f} +/- {err_msd:.6f} Ha")
    print(f"FCI                  : {ev[0]:12.6f} Ha")
    print(f"bias: single {abs(e_sd - ev[0]) * 1000:.2f} mHa, "
          f"2-det {abs(e_msd - ev[0]) * 1000:.2f} mHa")


if __name__ == "__main__":
    main()
