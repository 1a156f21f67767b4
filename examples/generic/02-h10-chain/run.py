"""H10 chain AFQMC, pyscf-free (see README.md).

Reference workflow: examples/generic/01-simple (pyscf scf.chk ->
pyscf_to_pauxy.py -> mpirun pauxy). Here: in-repo s-GTO integrals + UHF
-> AFQMC driver, one process.
"""

import sys

import jax

if "--gpu" not in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np

from pauxy_jax.models.trial import trial_from_orbitals
from pauxy_jax.qmc import AFQMC, QMCOpts
from pauxy_jax.utils.sgto import hydrogen_chain_afqmc


def main():
    ham, psi, e_uhf = hydrogen_chain_afqmc(10, 1.6, verbose=False)
    print(f"# UHF energy: {e_uhf:.8f} Ha")
    trial = trial_from_orbitals(ham, psi)
    qmc = QMCOpts(nwalkers=100, dt=0.005, nsteps=10, nblocks=1000,
                  nstblz=5, npop_control=5, rng_seed=8)
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": 10}},
               verbose=True, filename="h10_estimates.h5")
    rows = af.run()
    # Discard the first 1 a.u. (20 blocks) for equilibration; sigma from
    # 40-block reblocking (the series' autocorrelation tail is long —
    # smaller reblock sizes underestimate the error bar).
    et = rows[20:, 5].real
    b = et[: len(et) // 40 * 40].reshape(-1, 40).mean(axis=1)
    se = b.std(ddof=1) / len(b) ** 0.5
    print(f"# AFQMC H10 = {et.mean():.6f} +/- {se:.6f} Ha")
    print("# reference anchor: -5.38331344 +/- 0.0014386 Ha")


if __name__ == "__main__":
    main()
