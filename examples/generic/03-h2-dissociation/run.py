"""H2/STO-6G dissociation curve: RHF vs UHF vs phaseless AFQMC vs FCI.

A weak-to-strong correlation sweep on the smallest molecule — at
equilibrium the phaseless constraint is exact to <1 mHa; at stretched
geometries a small residual constrained-path bias remains (a property of
the method shared with the reference, not of this implementation; free
projection removes it, cf. tests/test_sgto.py).

    python examples/generic/03-h2-dissociation/run.py   # ~3 min on CPU
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

from pauxy_jax.estimators import ci
from pauxy_jax.models.trial import trial_from_orbitals
from pauxy_jax.qmc import AFQMC, QMCOpts
from pauxy_jax.utils.sgto import (build_integrals, hydrogen_chain,
                                  molecule_afqmc, rhf)


def point(r):
    bas, q, c, enuc = hydrogen_chain(2, r)
    e_rhf, _, _ = rhf(bas, q, c, 1, enuc=enuc,
                      ints=build_integrals(bas, q, c))
    # MO-basis pipeline with the UHF trial (see sgto._afqmc_arrays: the
    # localized-OAO Cholesky gives heavy-tailed phaseless local energies).
    ham, psi, e_uhf = molecule_afqmc(
        [("H", (0, 0, 0)), ("H", (r, 0, 0))], (1, 1))
    trial = trial_from_orbitals(ham, psi)
    ev, _, _ = ci.simple_fci(ham)
    # Stretched H2 has a small gap -> slow imaginary-time projection;
    # give it ~30 a.u. and discard the first half.
    qmc = QMCOpts(nwalkers=200, dt=0.01, nsteps=10, nblocks=300, nstblz=5,
                  npop_control=5, rng_seed=8)
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": 1}},
               filename=f"h2_r{r:.2f}.h5")
    rows = af.run()
    et = rows[150:, 5].real
    return e_rhf, e_uhf, et.mean(), et.std(ddof=1) / len(et) ** 0.5, ev[0]


def main():
    print(f"{'R/a0':>6} {'RHF':>10} {'UHF':>10} "
          f"{'AFQMC':>10} {'err':>8} {'FCI':>10}")
    for r in (1.0, 1.4, 2.0, 2.5, 3.0, 4.0):
        e_rhf, e_uhf, e_qmc, err, e_fci = point(r)
        print(f"{r:6.2f} {e_rhf:10.5f} {e_uhf:10.5f} "
              f"{e_qmc:10.5f} {err:8.5f} {e_fci:10.5f}")


if __name__ == "__main__":
    main()
