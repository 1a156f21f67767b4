"""Chemical-potential scan workflow: run thermal AFQMC at several mu,
reblock <N>(mu), and invert to the mu that hits a target filling.

Counterpart of the reference's
``examples/ftafqmc/scan_chem_pot/determine_nav.py`` +
``find_mu_opt/find_mu_opt.py`` scripts (driver re-built per mu, results
fed to ``analysis.thermal``).

    python examples/ftafqmc/scan_chem_pot.py [--gpu]
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.abspath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..")))

import jax

if "--gpu" not in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np

from pauxy_jax.analysis import thermal as thermal_analysis
from pauxy_jax.models import make_hubbard
from pauxy_jax.models.thermal_trial import make_one_body_trial
from pauxy_jax.qmc import QMCOpts
from pauxy_jax.qmc.thermal_afqmc import ThermalAFQMC


def main():
    beta, dt, target_nav = 1.0, 0.05, 6.0
    out = tempfile.mkdtemp(prefix="mu_scan_")
    files = []
    for mu in np.linspace(0.4, 1.4, 5):
        ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
        trial = make_one_body_trial(ham, beta, dt, mu=float(mu))
        qmc = QMCOpts(nwalkers=64, dt=dt, nsteps=1, nblocks=10, beta=beta,
                      npop_control=5, rng_seed=7)
        fn = os.path.join(out, f"estimates_mu{mu:.3f}.h5")
        af = ThermalAFQMC(ham, trial, qmc, filename=fn)
        af.run()
        files.append(fn)
        print(f"# mu = {mu:.3f} done")

    data = thermal_analysis.analyse_energy(files, skip=2)
    print(data.to_string())
    mu_opt = thermal_analysis.find_chem_pot(data, target_nav)
    print(f"# mu({target_nav} electrons) ~= {mu_opt:.4f}")


if __name__ == "__main__":
    main()
