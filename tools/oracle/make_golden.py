"""Generate golden validation data by running the reference (pauxy) serially.

Usage:
    PYTHONPATH=/root/repo/tools/oracle:/root/reference python tools/oracle/make_golden.py <outdir>

Produces, per config, an .npz with the trial orbitals used and the block
ETotal series, so pauxy_jax can be compared statistically *with the
identical trial wavefunction* (trajectories differ by design — RNG streams
are counter-based jax.random keys here, sequential host draws in the
reference).
"""

import json
import os
import sys

import numpy


def run_hubbard_4x4_uhf_continuous(outdir, blocks=100):
    numpy.random.seed(8)
    from mpi4py import MPI
    from pauxy.qmc.afqmc import AFQMC
    from pauxy.analysis.extraction import extract_mixed_estimates

    options = {
        "verbosity": 0,
        "get_sha1": False,
        "qmc": {
            "timestep": 0.01,
            "num_steps": 10,
            "blocks": blocks,
            "rng_seed": 8,
            "nwalkers": 40,
        },
        "model": {
            "name": "Hubbard", "nx": 4, "ny": 4, "nup": 7, "ndown": 7, "U": 4,
            # zero twist: mathematically untwisted; works around the
            # reference's numpy>=2 `array(None).all()` breakage.
            "ktwist": [0.0, 0.0],
        },
        "trial": {"name": "UHF"},
        "estimates": {
            "filename": os.path.join(outdir, "ref_hub4x4.h5"),
            "mixed": {"energy_eval_freq": 1},
        },
        "propagator": {"hubbard_stratonovich": "continuous"},
    }
    comm = MPI.COMM_WORLD
    af = AFQMC(comm=comm, options=options, verbose=0)
    af.run(comm=comm, verbose=False)
    df = extract_mixed_estimates(options["estimates"]["filename"])
    et = numpy.asarray(df.ETotal.values, dtype=complex).real
    psi = numpy.asarray(af.trial.psi)
    if psi.ndim == 3:  # MultiSlater wraps a single det as [1, M, ne]
        psi = psi[0]
    etrial = getattr(af.trial, "etrial", getattr(af.trial, "energy", 0.0))
    numpy.savez(
        os.path.join(outdir, "hubbard4x4_uhf_continuous.npz"),
        psi=psi,
        etrial=etrial,
        etotal_blocks=et,
        dt=0.01,
        nsteps=10,
        nwalkers=40,
    )
    skip = len(et) // 3
    print(
        json.dumps(
            {
                "config": "hubbard4x4_uhf_continuous",
                "etrial": float(numpy.real(etrial)),
                "mean": float(et[skip:].mean()),
                "stderr": float(et[skip:].std(ddof=1) / numpy.sqrt(len(et) - skip)),
                "blocks": len(et),
            }
        )
    )


def run_hubbard_4x4_uhf_discrete(outdir, blocks=100):
    numpy.random.seed(8)
    from mpi4py import MPI
    from pauxy.qmc.afqmc import AFQMC
    from pauxy.analysis.extraction import extract_mixed_estimates

    options = {
        "verbosity": 0,
        "get_sha1": False,
        "qmc": {
            "timestep": 0.01,
            "num_steps": 10,
            "blocks": blocks,
            "rng_seed": 8,
            "nwalkers": 40,
        },
        "model": {
            "name": "Hubbard", "nx": 4, "ny": 4, "nup": 7, "ndown": 7, "U": 4,
            "ktwist": [0.0, 0.0],
        },
        "trial": {"name": "UHF"},
        "estimates": {
            "filename": os.path.join(outdir, "ref_hub4x4_disc.h5"),
            "mixed": {"energy_eval_freq": 1},
        },
        "propagator": {"hubbard_stratonovich": "discrete"},
    }
    comm = MPI.COMM_WORLD
    af = AFQMC(comm=comm, options=options, verbose=0)
    af.run(comm=comm, verbose=False)
    df = extract_mixed_estimates(options["estimates"]["filename"])
    et = numpy.asarray(df.ETotal.values, dtype=complex).real
    psi = numpy.asarray(af.trial.psi)
    if psi.ndim == 3:
        psi = psi[0]
    etrial = getattr(af.trial, "etrial", getattr(af.trial, "energy", 0.0))
    numpy.savez(
        os.path.join(outdir, "hubbard4x4_uhf_discrete.npz"),
        psi=psi,
        etrial=etrial,
        etotal_blocks=et,
        dt=0.01,
        nsteps=10,
        nwalkers=40,
    )
    skip = len(et) // 3
    print(
        json.dumps(
            {
                "config": "hubbard4x4_uhf_discrete",
                "etrial": float(numpy.real(etrial)),
                "mean": float(et[skip:].mean()),
                "stderr": float(et[skip:].std(ddof=1) / numpy.sqrt(len(et) - skip)),
                "blocks": len(et),
            }
        )
    )


def run_thermal_ueg_lowrank(outdir, blocks=40):
    """Thermal UEG rs=1 beta=0.5 mu=0.245 ecut=4, low-rank stack — the
    reference regression family of pauxy/qmc/tests/test_thermal_afqmc.py
    (whose pinned block-1 values are a single 10-walker sample; this stores
    a many-block series for a statistical comparison)."""
    numpy.random.seed(8)
    import ueg_kernels_shim

    ueg_kernels_shim.inject()
    from mpi4py import MPI
    from pauxy.qmc.thermal_afqmc import ThermalAFQMC
    from pauxy.analysis.extraction import extract_data

    options = {
        "verbosity": 0,
        "get_sha1": False,
        "qmc": {
            "timestep": 0.05,
            "rng_seed": 8,
            "nblocks": blocks,
            "nwalkers": 10,
            "beta": 0.5,
            "pop_control_freq": 1,
        },
        "model": {
            "name": "UEG", "rs": 1.0, "ecut": 4, "nup": 1, "ndown": 1,
            "mu": 0.245,
        },
        "trial": {"name": "one_body"},
        "walkers": {"low_rank": True, "low_rank_thresh": 1e-6},
        "estimators": {"filename": os.path.join(outdir, "tmp_tueg.h5")},
    }
    comm = MPI.COMM_WORLD
    afqmc = ThermalAFQMC(comm=comm, options=options, verbose=0)
    afqmc.run(comm=comm)
    afqmc.finalise(verbose=0)
    data = extract_data(afqmc.estimators.filename, "basic", "energies")
    numpy.savez(
        os.path.join(outdir, "thermal_ueg_lowrank.npz"),
        etotal=numpy.real(data.ETotal.values),
        nav=numpy.real(data.Nav.values),
        weight_factor=numpy.real(data.WeightFactor.values),
        beta=0.5, dt=0.05, mu=0.245, rs=1.0, ecut=4.0, nwalkers=10,
        nblocks=blocks,
    )
    os.remove(afqmc.estimators.filename)
    print("thermal_ueg_lowrank:",
          numpy.real(data.ETotal.values[:3]), "...",
          numpy.real(data.ETotal.values[1:]).mean())


def run_ueg(outdir, blocks=100):
    """UEG rs=2.44 ecut=2 (7,7), HF trial — the reference regression family
    of pauxy/qmc/tests/test_afqmc.py:49-97, run long for statistics."""
    numpy.random.seed(8)
    import ueg_kernels_shim

    ueg_kernels_shim.inject()
    from mpi4py import MPI
    from pauxy.qmc.afqmc import AFQMC
    from pauxy.analysis.extraction import extract_mixed_estimates

    options = {
        "verbosity": 0,
        "get_sha1": False,
        "qmc": {"timestep": 0.01, "num_steps": 10, "blocks": blocks,
                "rng_seed": 8, "nwalkers": 40},
        "model": {"name": "UEG", "rs": 2.44, "ecut": 2, "nup": 7, "ndown": 7},
        "estimates": {
            "filename": os.path.join(outdir, "ref_ueg.h5"),
            "mixed": {"energy_eval_freq": 1},
        },
        "trial": {"name": "hartree_fock"},
    }
    comm = MPI.COMM_WORLD
    af = AFQMC(comm=comm, options=options, verbose=0)
    af.run(comm=comm, verbose=False)
    df = extract_mixed_estimates(options["estimates"]["filename"])
    et = numpy.asarray(df.ETotal.values, dtype=complex).real
    numpy.savez(
        os.path.join(outdir, "ueg_rs2.44_ecut2.npz"),
        etotal_blocks=et,
        etrial=float(numpy.real(af.trial.energy)),
        rs=2.44, ecut=2.0, nup=7, ndown=7, dt=0.01, nsteps=10, nwalkers=40,
    )
    os.remove(options["estimates"]["filename"])
    skip = len(et) // 3
    print(json.dumps({
        "config": "ueg_rs2.44_ecut2",
        "etrial": float(numpy.real(af.trial.energy)),
        "mean": float(et[skip:].mean()),
        "stderr": float(et[skip:].std(ddof=1) / numpy.sqrt(len(et) - skip)),
        "blocks": len(et),
    }))


def run_generic(outdir, blocks=100):
    """Random Generic nmo=11 (3,3) seed-7 Hamiltonian — the reference
    regression family of pauxy/qmc/tests/test_afqmc.py:191-232."""
    numpy.random.seed(8)
    from mpi4py import MPI
    from pauxy.qmc.afqmc import AFQMC
    from pauxy.systems.generic import Generic
    from pauxy.utils.testing import generate_hamiltonian
    from pauxy.analysis.extraction import extract_mixed_estimates

    nmo, nelec = 11, (3, 3)
    numpy.random.seed(7)
    h1e, chol, enuc, eri = generate_hamiltonian(nmo, nelec, cplx=False)
    numpy.random.seed(8)
    sys_ = Generic(nelec=nelec, h1e=numpy.array([h1e, h1e]),
                   chol=chol.reshape((-1, nmo * nmo)).T.copy(), ecore=enuc)
    options = {
        "verbosity": 0,
        "get_sha1": False,
        "qmc": {"timestep": 0.005, "num_steps": 10, "blocks": blocks,
                "rng_seed": 8, "nwalkers": 40},
        "estimates": {
            "filename": os.path.join(outdir, "ref_gen.h5"),
            "mixed": {"energy_eval_freq": 1},
        },
        "trial": {"name": "MultiSlater"},
    }
    comm = MPI.COMM_WORLD
    af = AFQMC(comm=comm, system=sys_, options=options, verbose=0)
    af.run(comm=comm, verbose=False)
    df = extract_mixed_estimates(options["estimates"]["filename"])
    et = numpy.asarray(df.ETotal.values, dtype=complex).real
    psi = numpy.asarray(af.trial.psi)
    if psi.ndim == 3:
        psi = psi[0]
    numpy.savez(
        os.path.join(outdir, "generic_nmo11.npz"),
        etotal_blocks=et,
        h1e=h1e, chol=chol, enuc=enuc, psi=psi,
        dt=0.005, nsteps=10, nwalkers=40,
    )
    os.remove(options["estimates"]["filename"])
    skip = len(et) // 3
    print(json.dumps({
        "config": "generic_nmo11",
        "mean": float(et[skip:].mean()),
        "stderr": float(et[skip:].std(ddof=1) / numpy.sqrt(len(et) - skip)),
        "blocks": len(et),
    }))


if __name__ == "__main__":
    outdir = sys.argv[1] if len(sys.argv) > 1 else "tests/data"
    os.makedirs(outdir, exist_ok=True)
    which = sys.argv[2] if len(sys.argv) > 2 else "all"
    if which in ("all", "continuous"):
        run_hubbard_4x4_uhf_continuous(outdir)
    if which in ("all", "discrete"):
        run_hubbard_4x4_uhf_discrete(outdir)
    if which in ("all", "thermal_ueg"):
        run_thermal_ueg_lowrank(outdir)
    if which in ("all", "ueg"):
        run_ueg(outdir)
    if which in ("all", "generic"):
        run_generic(outdir)
