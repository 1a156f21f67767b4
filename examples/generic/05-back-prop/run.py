"""Back-propagated 1-RDM for H4: pure-estimator observables.

Counterpart of the reference's ``examples/generic/03-back_prop``: the
mixed estimator gives the MIXED density matrix <psi_T| n |phi>, which is
biased for observables that do not commute with H; back propagation
projects the bra as well (``pauxy/estimators/back_propagation.py``).
Here both 1-RDMs are extracted from the same run's HDF5 output and the
natural-orbital occupations are compared with the exact FCI ones.

    python examples/generic/05-back-prop/run.py   # ~2 min on CPU
"""

import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "..")))

import jax

if "--gpu" not in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np

from pauxy_jax.analysis.extraction import extract_rdm
from pauxy_jax.estimators import ci
from pauxy_jax.models.trial import trial_from_orbitals
from pauxy_jax.qmc import AFQMC, QMCOpts
from pauxy_jax.utils.sgto import hydrogen_chain_afqmc

R, NELEC = 1.8, (2, 2)


def natocc(p):
    """Natural occupations of a spin-summed 1-RDM (descending)."""
    return np.sort(np.linalg.eigvalsh(p))[::-1]


def main():
    ham, psi_uhf, _ = hydrogen_chain_afqmc(4, R, nelec=NELEC)
    trial = trial_from_orbitals(ham, psi_uhf)
    qmc = QMCOpts(nwalkers=128, dt=0.01, nsteps=10, nblocks=100, nstblz=5,
                  npop_control=5, rng_seed=8)
    af = AFQMC(
        ham, trial, qmc,
        estimator_options={
            "mixed": {"energy_eval_freq": 1, "one_rdm": True},
            "back_propagation": {"tau_bp": 2.0, "evaluate_energy": True},
        },
        filename="h4_bp.h5",
    )
    af.run()

    skip = 30
    p_mix = extract_rdm("h4_bp.h5", est_type="basic")[skip:].mean(axis=0)
    # Blocks whose BP window did not complete are NaN-normalized
    # (denominator 0); keep the measured rows past equilibration.
    bp_series = extract_rdm("h4_bp.h5", est_type="back_propagated")
    valid = np.isfinite(bp_series.reshape(len(bp_series), -1)).all(axis=1)
    p_bp = bp_series[valid][3:].mean(axis=0)

    # Exact 1-RDM from the FCI ground state.
    ev, evec, space = ci.simple_fci(ham)
    p_fci = ci.one_rdm_from_fci(evec[:, 0], space, ham.nbasis)

    n_mix = natocc((p_mix[0] + p_mix[1]).real)
    n_bp = natocc((p_bp[0] + p_bp[1]).real)
    n_fci = natocc((p_fci[0] + p_fci[1]).real)
    print(f"{'NO':>3} {'mixed':>9} {'back-prop':>10} {'FCI':>9}")
    for i in range(ham.nbasis):
        print(f"{i:3d} {n_mix[i]:9.5f} {n_bp[i]:10.5f} {n_fci[i]:9.5f}")
    err_mix = np.abs(n_mix - n_fci).max()
    err_bp = np.abs(n_bp - n_fci).max()
    print(f"max |occ error|: mixed {err_mix:.5f}, back-prop {err_bp:.5f}")


if __name__ == "__main__":
    main()
