"""Input-file driven calculation setup.

Counterpart of ``pauxy/qmc/calc.py:33-103`` and the string-keyed factories
(``pauxy/systems/utils.py:9``, ``pauxy/trial_wavefunction/utils.py:12``,
``pauxy/trial_density_matrices/utils.py:4``): the same JSON schema
(sections ``system|model``, ``qmc``, ``trial``, ``propagator``,
``estimates|estimators``) builds and returns a ready-to-run driver.
"""

from __future__ import annotations

import json

from pauxy_jax.qmc.options import QMCOpts
from pauxy_jax.utils.io import get_input_value


def get_system(model_opts: dict, precision=None):
    name = model_opts.get("name", "Generic")
    if name == "Hubbard":
        from pauxy_jax.models.hubbard import make_hubbard

        return make_hubbard(
            nup=model_opts["nup"],
            ndown=model_opts["ndown"],
            U=model_opts["U"],
            nx=model_opts["nx"],
            ny=model_opts.get("ny", 1),
            t=model_opts.get("t", 1.0),
            ktwist=model_opts.get("ktwist"),
            xpbc=model_opts.get("xpbc", True),
            ypbc=model_opts.get("ypbc", True),
            symmetric=model_opts.get("symmetric", False),
            pinning_fields=model_opts.get("pinning_fields", False),
            precision=precision,
        )
    if name == "HubbardHolstein":
        from pauxy_jax.models.hubbard_holstein import make_hubbard_holstein

        return make_hubbard_holstein(
            nup=model_opts["nup"],
            ndown=model_opts["ndown"],
            U=model_opts["U"],
            nx=model_opts["nx"],
            ny=model_opts.get("ny", 1),
            t=model_opts.get("t", 1.0),
            w0=model_opts.get("w0", 1.0),
            lmbda=model_opts.get("lambda", model_opts.get("lmbda", 0.5)),
            precision=precision,
        )
    if name == "PW_FFT":
        from pauxy_jax.models.pw_fft import make_pw_fft

        return make_pw_fft(
            nup=model_opts["nup"],
            ndown=model_opts["ndown"],
            rs=model_opts["rs"],
            ecut=model_opts["ecut"],
            ktwist=model_opts.get("ktwist"),
            precision=precision,
        )
    if name == "UEG":
        from pauxy_jax.models.ueg import make_ueg

        return make_ueg(
            nup=model_opts["nup"],
            ndown=model_opts["ndown"],
            rs=model_opts["rs"],
            ecut=model_opts["ecut"],
            ktwist=model_opts.get("ktwist"),
            precision=precision,
        )
    if name == "Generic":
        from pauxy_jax.models.generic import from_qmcpack_file

        integrals = get_input_value(
            model_opts, "integrals", default=None, alias=["integral_file"]
        )
        if integrals is None:
            raise ValueError("Generic system needs an 'integrals' file")
        nelec = None
        if "nup" in model_opts:
            nelec = (model_opts["nup"], model_opts["ndown"])
        ham = from_qmcpack_file(integrals, nelec=nelec, precision=precision)
        # Local-energy variant flags (systems/generic.py:74-123).
        flags = dict(
            exact_eri=bool(model_opts.get("exact_eri", False)),
            stochastic_ri=bool(model_opts.get("stochastic_ri", False)),
            nsamples=int(model_opts.get("nsamples", 0)),
            control_variate=bool(model_opts.get("control_variate", False)),
            pno=bool(model_opts.get("pno", False)),
            thresh_pno=float(model_opts.get("thresh_pno", 0.0) or 0.0),
        )
        if any(flags.values()):
            ham = ham.replace(**flags)
        return ham
    raise NotImplementedError(f"unknown system {name!r}")


def get_trial_wavefunction(ham, trial_opts: dict, precision=None, seed=None):
    from pauxy_jax.models import trial as tr

    trial = _build_trial(ham, trial_opts, precision, seed)
    # Optional spin projection of the walkers' initial determinant
    # (reference trial_wavefunction/utils.py:123-144).
    if trial_opts.get("spin_proj", trial_opts.get("spin_project")):
        trial, _ = tr.spin_project_init(
            ham, trial, init_walker=trial_opts.get(
                "init_walker", trial_opts.get("initial_walker"))
        )
    return trial


def _build_trial(ham, trial_opts: dict, precision=None, seed=None):
    from pauxy_jax.models import trial as tr

    name = trial_opts.get("name", "MultiSlater").lower()
    if name in ("free_electron",):
        return tr.free_electron_trial(ham, precision=precision)
    if name in ("uhf",):
        return tr.uhf_trial(
            ham,
            ueff=trial_opts.get("ueff", 0.4),
            ninitial=trial_opts.get("ninitial", 10),
            nconv=trial_opts.get("nconv", 5000),
            alpha=trial_opts.get("alpha", 0.5),
            deps=trial_opts.get("deps", 1e-8),
            seed=seed,
            precision=precision,
        )
    if name in ("coherent_state",):
        if trial_opts.get("symmetrize", False):
            # Translation-symmetrized multi-coherent expansion
            # (coherent_state.py:464-472 + walkers/multi_coherent.py).
            from pauxy_jax.models.multi_coherent import multi_coherent_trial

            return multi_coherent_trial(ham, precision=precision)
        from pauxy_jax.models.hubbard_holstein import coherent_state_trial

        return coherent_state_trial(ham, precision=precision)
    if name in ("lang_firsov",):
        from pauxy_jax.models.hubbard_holstein import lang_firsov_trial

        trial, _gamma = lang_firsov_trial(
            ham,
            relax_gamma=trial_opts.get("relax_gamma", False),
            restricted=trial_opts.get("restricted", False),
            precision=precision,
        )
        return trial
    if name in ("phmsd",):
        from pauxy_jax.models.multi_slater import phmsd_trial

        return phmsd_trial(
            ham,
            coeffs=trial_opts["coefficients"],
            occa=trial_opts["occa"],
            occb=trial_opts["occb"],
            precision=precision,
        )
    if name in ("hartree_fock", "multislater"):
        filename = trial_opts.get("filename")
        exc = trial_opts.get("excitation", trial_opts.get("excite_ia"))
        if filename is not None:
            if exc is not None:
                raise NotImplementedError(
                    "trial.excitation with a wavefunction file is not "
                    "supported; apply the excitation when writing the file"
                )
            from pauxy_jax.utils import wavefunction as wio

            return wio.read_wavefunction(ham, filename, precision=precision)
        if exc is not None:
            # "Promotion energy" excitation in the (energy-ordered) MO
            # basis: replace occupied alpha orbital i with virtual a
            # (reference trial_wavefunction/hartree_fock.py:57-77; alpha
            # spin only, like the reference).
            import numpy as np

            i, a = int(exc[0]), int(exc[1])
            m, na, nb = ham.nbasis, ham.nup, ham.ndown
            if not (0 <= i < na and na <= a < m):
                raise ValueError(
                    f"trial.excitation=[{i}, {a}]: i must be an occupied "
                    f"alpha MO (0..{na - 1}) and a a virtual MO "
                    f"({na}..{m - 1}); beta excitations are not supported "
                    "(matching the reference, hartree_fock.py:57-59)"
                )
            psi = np.zeros((m, na + nb), dtype=np.complex128)
            psi[:na, :na] = np.eye(na)
            psi[:nb, na:] = np.eye(nb)
            psi[:, i] = 0.0
            psi[a, i] = 1.0
            return tr.trial_from_orbitals(
                ham, psi, precision=precision, name="hartree_fock")
        return tr.rhf_identity_trial(ham, precision=precision)
    if name in ("multi_determinant",):
        # GHF multi-determinant expansion from the reference ascii format
        # (trial_wavefunction/multi_determinant.py:27-34 options).
        from pauxy_jax.models.ghf import ghf_trial_from_files

        return ghf_trial_from_files(
            ham,
            orbital_file=trial_opts["orbitals"],
            coeffs_file=trial_opts["coefficients"],
            ndets=int(trial_opts["ndets"]),
            precision=precision,
        )
    raise NotImplementedError(f"unknown trial {name!r}")


def get_driver(options: dict, verbose: bool = False):
    """Dispatch on presence of qmc.beta (calc.py:42-55)."""
    model = options.get("model", options.get("system", {}))
    qmc_opts = options.get("qmc", {})
    qmc = QMCOpts.from_dict(qmc_opts, verbose=verbose)
    ham = get_system(model)
    if qmc.scaled_temp:
        # theta = T/T_F input (UEG): rescale beta/dt to Hartree units
        # (options.py:5-19 + 114-118).
        qmc.convert_from_reduced_units(ham, verbose=verbose)
    est = options.get("estimates", options.get("estimators", {})) or {}
    popts = options.get("propagator", options.get("propagators", {})) or {}

    if qmc.beta is not None:
        from pauxy_jax.models.thermal_trial import make_one_body_trial
        from pauxy_jax.qmc.thermal_afqmc import ThermalAFQMC

        topts = options.get("trial", {}) or {}
        if topts.get("spin_proj", topts.get("spin_project")):
            import warnings

            warnings.warn(
                "trial.spin_proj applies to zero-temperature trials only; "
                "ignored for finite-temperature (qmc.beta) runs",
                stacklevel=2,
            )
        # The trial bisects its own mu to the target <N> unless given one in
        # the trial section; the model-section mu is the SYSTEM chemical
        # potential and goes to the propagator (onebody.py:50 reads only
        # trial options; planewave.py:106 uses system.mu).
        # Factory keyed on trial name like the reference
        # (trial_density_matrices/utils.py:4): 'one_body' (default) or
        # 'mean_field' (thermal Hartree-Fock).
        tname = str(topts.get("name", "one_body")).lower()
        if tname in ("mean_field", "thermal_hartree_fock"):
            from pauxy_jax.models.thermal_trial import make_mean_field_trial

            trial = make_mean_field_trial(
                ham, qmc.beta, qmc.dt,
                mu=topts.get("mu"),
                find_mu=bool(topts.get("find_mu", True)),
                nav=topts.get("nav"),
                stack_size=topts.get("stack_size"),
                alpha=float(topts.get("alpha", 0.75)),
                verbose=verbose,
            )
        elif tname == "one_body":
            trial = make_one_body_trial(
                ham, qmc.beta, qmc.dt,
                mu=topts.get("mu"),
                nav=topts.get("nav"),
                stack_size=topts.get("stack_size"),
            )
        else:
            raise ValueError(
                f"unknown thermal trial name {tname!r}; "
                "expected 'one_body' or 'mean_field'"
            )
        popts = dict(popts)
        if model.get("mu") is not None:
            popts.setdefault("mu", model["mu"])
        return ThermalAFQMC(
            ham, trial, qmc,
            propagator_options=popts,
            estimator_options=est,
            walker_options=options.get("walkers", {}) or {},
            verbose=verbose,
            filename=est.get("filename"),
        )

    from pauxy_jax.qmc.afqmc import AFQMC

    trial = get_trial_wavefunction(
        ham, options.get("trial", {}) or {}, seed=qmc.rng_seed
    )
    return AFQMC(
        ham, trial, qmc,
        propagator_options=popts,
        estimator_options=est,
        verbose=verbose,
        filename=est.get("filename"),
    )


def setup_calculation(input_options):
    """input.json path or dict -> driver (calc.py:33-41)."""
    if isinstance(input_options, str):
        with open(input_options) as f:
            options = json.load(f)
    else:
        options = dict(input_options)
    verbose = options.get("verbosity", options.get("verbose", 1))
    return get_driver(options, verbose=bool(verbose))
