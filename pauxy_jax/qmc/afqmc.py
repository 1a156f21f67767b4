"""Zero-temperature AFQMC driver.

Batched counterpart of ``pauxy/qmc/afqmc.py:27-330``. The reference's hot
loop — a Python ``for`` over steps containing a Python ``for`` over walkers
(``afqmc.py:223-255``) — becomes ONE jitted ``lax.scan`` over the steps of a
block, with the whole walker population propagated as batched linear algebra
and population control / re-orthogonalisation dispatched by ``lax.cond`` on
the step index. Only block boundaries touch the host (stdout/HDF5 row,
eshift update).

Multi-chip: the walker axis of the state pytree is sharded over a
``jax.sharding.Mesh``; the same step program then runs SPMD with XLA
inserting the collectives (sums for estimators, gather traffic for
population control) between the devices.
"""

from __future__ import annotations

import functools
import time
import uuid

import jax
import jax.numpy as jnp
import numpy as np

from pauxy_jax import config
from pauxy_jax.estimators import mixed
from pauxy_jax.propagation import continuous
from pauxy_jax.utils.io import H5EstimatorHelper, create_estimates_file
from pauxy_jax.utils.transfer import device_scalar
from pauxy_jax.qmc.options import QMCOpts
from pauxy_jax.walkers import pop_control as pc
from pauxy_jax.walkers import state as walker_state


@functools.partial(
    jax.jit,
    static_argnames=(
        "nsteps",
        "nstblz",
        "npop_control",
        "pop_method",
        "target_weight",
        "energy_eval_freq",
        "free_projection",
        "calc_one_rdm",
        "calc_two_rdm",
        "nbp",
        "bp_nsplit",
        "bp_restore",
        "bp_two_rdm",
        "bp_eval_energy",
        "bp_eval_ekt",
        "nprop_tot",
        "nitcf",
        "itcf_stable",
        "itcf_restore",
        "itcf_stack_size",
    ),
)
def run_block(
    ham,
    trial,
    prop,
    state,
    block_key,
    eshift,
    step0,
    *,
    nsteps: int,
    nstblz: int,
    npop_control: int,
    pop_method: str,
    target_weight: float,
    energy_eval_freq: int,
    free_projection: bool,
    calc_one_rdm: bool = False,
    calc_two_rdm: str | None = None,
    nbp: int = 0,
    bp_nsplit: int = 1,
    bp_restore: str | None = None,
    bp_two_rdm: str | None = None,
    bp_eval_energy: bool = False,
    bp_eval_ekt: bool = False,
    nprop_tot: int = 0,
    nitcf: int = 0,
    itcf_stable: bool = True,
    itcf_restore: bool = True,
    itcf_stack_size: int = 1,
):
    """Run ``nsteps`` QMC steps and return (state, mixed accumulator,
    BP accumulator or None).

    Step ordering matches ``afqmc.py:223-255``: reortho (on nstblz steps),
    propagate, weight cap at 10% of total weight, population control (on
    npop_control steps), estimator update, BP measurement every nbp steps.
    """
    from pauxy_jax.estimators import back_prop
    from pauxy_jax.estimators import itcf as itcf_mod
    from pauxy_jax.propagation.hirsch import Hirsch

    discrete = isinstance(prop, Hirsch)
    m = state.nbasis
    nhist = nprop_tot if nprop_tot else nbp

    def bp_measure(state, nbp_len):
        e_fn = None
        if bp_eval_energy:
            e_fn = lambda ga, gb: mixed.energy_estimator_G(ham, trial)(ga, gb)
        return back_prop.update(
            ham, trial, prop, state, e_fn,
            nstblz=nstblz, restore_weights=bp_restore, discrete=discrete,
            eval_ekt=bp_eval_ekt, nbp_len=nbp_len, calc_two_rdm=bp_two_rdm,
        )

    def one_step(state, inp):
        step, key = inp
        kprop, kpop, kest = jax.random.split(key, 3)

        state = jax.lax.cond(
            step % nstblz == 0,
            lambda s: walker_state.orthogonalise(s, free_projection),
            lambda s: s,
            state,
        )

        bp_ix = ((step - 1) % nhist) if nhist else None
        state = prop.propagate(trial, state, kprop, eshift, bp_ix=bp_ix,
                               ham=ham)

        # Cap runaway weights at 10% of the total (afqmc.py:235-236).
        cap = 0.10 * state.total_weight
        state = state.replace(
            weight=jnp.where(
                (step > 1) & (jnp.abs(state.weight) > cap), cap, state.weight
            )
        )

        state = jax.lax.cond(
            step % npop_control == 0,
            lambda s: pc.pop_control(s, kpop, target_weight, pop_method),
            lambda s: s,
            state,
        )

        acc = mixed.update(
            ham,
            trial,
            state,
            eval_energy=(step % energy_eval_freq == 0),
            free_projection=free_projection,
            calc_one_rdm=calc_one_rdm,
            calc_two_rdm=calc_two_rdm,
            est_key=kest,
        )

        if nbp:
            nacc_bp = (4 + 2 * m * m
                       + back_prop.bp_two_rdm_size(ham, bp_two_rdm)
                       + (2 * m * m if bp_eval_ekt else 0))
            # Multi-split schedule (back_propagation.py:70-72,144-147): the
            # buffer count after this step is (step-1) % nhist + 1; measure
            # whenever it hits a split point, back-propagating through the
            # first `s` stored configs.
            splits = tuple((i + 1) * (nbp // bp_nsplit)
                           for i in range(bp_nsplit))
            buffcount = (step - 1) % nhist + 1
            accs = []
            for s in splits:
                accs.append(
                    jax.lax.cond(
                        buffcount == s,
                        lambda st, s=s: bp_measure(st, s),
                        lambda st: jnp.zeros((nacc_bp,), state.log_ovlp.dtype),
                        state,
                    )
                )
            bp_acc = jnp.concatenate(accs)
            # After the LAST split: new historic wavefunction + fresh factors
            # (handler.py:200-214 copy_historic_wfn + stack.py:121-127 reset;
            # back_propagation.py:220-223).
            state = jax.lax.cond(
                buffcount == splits[-1],
                lambda s: s.replace(
                    phia_old=s.phia,
                    phib_old=s.phib,
                    cos_fac=jnp.ones_like(s.cos_fac),
                    weight_fac=jnp.ones_like(s.weight_fac),
                ),
                lambda s: s,
                state,
            )
        else:
            bp_acc = jnp.zeros((0,), state.log_ovlp.dtype)

        if nitcf:
            ntau = nitcf // itcf_stack_size
            nacc_itcf = 1 + (ntau + 1) * 4 * m * m

            def itcf_measure(s):
                return itcf_mod.measure(
                    prop, trial, s,
                    nmax=nitcf, nstblz=nstblz, stable=itcf_stable,
                    restore_weights=itcf_restore, discrete=discrete,
                    stack_size=itcf_stack_size,
                )

            itcf_acc = jax.lax.cond(
                step % nhist == 0,
                itcf_measure,
                lambda s: jnp.zeros((nacc_itcf,), state.log_ovlp.dtype),
                state,
            )
            state = jax.lax.cond(
                step % nhist == 0,
                lambda s: s.replace(
                    phia_right=s.phia,
                    phib_right=s.phib,
                    cos_fac=jnp.ones_like(s.cos_fac),
                    weight_fac=jnp.ones_like(s.weight_fac),
                ),
                lambda s: s,
                state,
            )
        else:
            itcf_acc = jnp.zeros((0,), state.log_ovlp.dtype)
        return state, (acc, bp_acc, itcf_acc)

    steps = step0 + 1 + jnp.arange(nsteps)
    keys = jax.random.split(block_key, nsteps)
    state, (accs, bp_accs, itcf_accs) = jax.lax.scan(
        one_step, state, (steps, keys)
    )

    def as_real(x):
        # Accumulators leave the device as stacked real/imag parts — the
        # backend cannot transfer complex buffers (utils/transfer.py).
        s = jnp.sum(x, axis=0)
        return jnp.stack([s.real, s.imag])

    return state, as_real(accs), as_real(bp_accs), as_real(itcf_accs)


# ----------------------------------------------------------------------------
# Split-dispatch step pieces: one small jit per phase, timed separately
# (AFQMC(block_mode="split") / PAUXY_SPLIT=1).
# ----------------------------------------------------------------------------

def check_population_alive(weight, hint: str):
    """Raise when the population's total |weight| has vanished — the
    reference's abort (``walkers/handler.py:236-241``, sum of |w| inside
    pop control). Checking |w| (not the phased Weight column) keeps
    free-projection runs — whose PHASED sum legitimately decays — alive.
    Host-side, called at block boundaries by both drivers."""
    total = float(np.abs(np.asarray(weight)).sum())
    if total < 1e-8:
        raise RuntimeError(
            f"Total weight is {total:13.8e}: the walker population died. "
            f"Something is seriously wrong — {hint}."
        )


@functools.partial(jax.jit, static_argnames=("free_projection",))
def _step_ortho(state, free_projection: bool):
    return walker_state.orthogonalise(state, free_projection)


@functools.partial(jax.jit, static_argnames=("with_bp",))
def _step_propagate(prop, trial, state, key, eshift, ham=None,
                    bp_ix=None, with_bp: bool = False):
    return prop.propagate(trial, state, key, eshift, ham=ham,
                          bp_ix=bp_ix if with_bp else None)


@functools.partial(
    jax.jit,
    static_argnames=("nstblz", "restore_weights", "discrete", "eval_ekt",
                     "eval_energy", "nbp_len", "calc_two_rdm"),
)
def _step_bp(ham, trial, prop, state, *, nstblz: int,
             restore_weights: str | None, discrete: bool, eval_ekt: bool,
             eval_energy: bool, nbp_len: int, calc_two_rdm: str | None = None):
    from pauxy_jax.estimators import back_prop

    e_fn = None
    if eval_energy:
        e_fn = lambda ga, gb: mixed.energy_estimator_G(ham, trial)(ga, gb)
    acc = back_prop.update(
        ham, trial, prop, state, e_fn, nstblz=nstblz,
        restore_weights=restore_weights, discrete=discrete,
        eval_ekt=eval_ekt, nbp_len=nbp_len, calc_two_rdm=calc_two_rdm,
    )
    return jnp.stack([acc.real, acc.imag])


@functools.partial(
    jax.jit,
    static_argnames=("nmax", "nstblz", "stable", "restore_weights",
                     "discrete", "stack_size"),
)
def _step_itcf(prop, trial, state, *, nmax: int, nstblz: int, stable: bool,
               restore_weights: bool, discrete: bool, stack_size: int = 1):
    from pauxy_jax.estimators import itcf as itcf_mod

    acc = itcf_mod.measure(
        prop, trial, state, nmax=nmax, nstblz=nstblz, stable=stable,
        restore_weights=restore_weights, discrete=discrete,
        stack_size=stack_size,
    )
    return jnp.stack([acc.real, acc.imag])


@jax.jit
def _reset_history_bp(state):
    return state.replace(
        phia_old=state.phia,
        phib_old=state.phib,
        cos_fac=jnp.ones_like(state.cos_fac),
        weight_fac=jnp.ones_like(state.weight_fac),
    )


@jax.jit
def _reset_history_itcf(state):
    return state.replace(
        phia_right=state.phia,
        phib_right=state.phib,
        cos_fac=jnp.ones_like(state.cos_fac),
        weight_fac=jnp.ones_like(state.weight_fac),
    )


@jax.jit
def _step_cap(state):
    cap = 0.10 * state.total_weight
    return state.replace(
        weight=jnp.where(jnp.abs(state.weight) > cap, cap, state.weight)
    )


@functools.partial(jax.jit, static_argnames=("target_weight", "pop_method"))
def _step_pop(state, key, target_weight: float, pop_method: str):
    return pc.pop_control(state, key, target_weight, pop_method)


@functools.partial(
    jax.jit,
    static_argnames=("eval_energy", "free_projection", "calc_one_rdm",
                     "calc_two_rdm"),
)
def _step_mixed(ham, trial, state, eval_energy: bool, free_projection: bool,
                calc_one_rdm: bool = False, calc_two_rdm: str | None = None,
                est_key=None):
    acc = mixed.update(ham, trial, state, eval_energy, free_projection,
                       calc_one_rdm=calc_one_rdm, calc_two_rdm=calc_two_rdm,
                       est_key=est_key)
    return jnp.stack([acc.real, acc.imag])


class AFQMC:
    """Zero-temperature AFQMC simulation.

    Parameters mirror the reference driver's constituents: a Hamiltonian
    container, a trial wavefunction, QMC options and propagator options.
    """

    def __init__(
        self,
        ham,
        trial,
        qmc: QMCOpts,
        propagator_options: dict | None = None,
        estimator_options: dict | None = None,
        walker_options: dict | None = None,
        verbose: bool = False,
        filename: str | None = None,
        precision=None,
        block_mode: str | None = None,
        profile_dir: str | None = None,
    ):
        import os as _os

        self._t_init = time.time()
        # Per-phase wall-clock accumulators (afqmc.py:224-279 timing
        # breakdown). Fused mode is one compiled program, so only the
        # block total is observable there; split mode times each phase.
        self.timing = {"setup": 0.0, "block": 0.0, "ortho": 0.0,
                       "prop": 0.0, "pop": 0.0, "estim": 0.0}
        self.block_mode = block_mode or (
            "split" if _os.environ.get("PAUXY_SPLIT") == "1" else "fused"
        )
        self.profile_dir = profile_dir
        self.uuid = str(uuid.uuid1())
        self.ham = ham
        self.trial = trial
        self.qmc = qmc
        self.verbose = verbose
        self.prec = config.get_precision(precision)
        popts = dict(propagator_options or {})
        eopts = dict(estimator_options or {})
        # f32 matmuls keep full f32 accuracy by default; 'tensorfloat32'
        # is the opt-in faster tier (config.MATMUL_TIERS).
        self.matmul_precision = config.set_matmul_precision(
            popts.get("matmul_precision")
        )

        self.free_projection = popts.get("free_projection", False)
        self.hybrid = popts.get("hybrid", True)

        self.prop = self._build_propagator(popts)
        # Discrete propagation reports the projected (not hybrid) energy as
        # the shift (hubbard.py:82 sets hybrid=False).
        self.hybrid = getattr(self.prop, "hybrid", self.hybrid)

        # Back propagation configuration (estimators/handler.py:83-107 +
        # back_propagation.py:64-72).
        bp_opts = eopts.get("back_propagation", eopts.get("back_propagated"))
        itcf_requested = eopts.get("itcf") is not None
        if bp_opts is not None or itcf_requested:
            # BP/ITCF back-propagate the TRIAL determinant through the
            # stored fields; like the reference these paths are single-
            # determinant only (back_propagation.py:116-127 dispatches
            # update_uhf; its GHF branch exits "Back Propagation with GHF
            # is broken", :227-248; no multi-det branch exists). Fail at
            # setup with a clear message instead of a shape error mid-run.
            from pauxy_jax.models.ghf import GHFTrial
            from pauxy_jax.models.multi_coherent import MultiCoherentTrial

            what = "back_propagation" if bp_opts is not None else "itcf"
            if isinstance(trial, (GHFTrial, MultiCoherentTrial)):
                raise NotImplementedError(
                    f"{what} supports single-determinant UHF-style trials "
                    "only (the reference's GHF back propagation is "
                    "self-declared broken, back_propagation.py:227-248)"
                )
            if getattr(trial, "ndets", 1) > 1:
                raise NotImplementedError(
                    f"{what} is single-determinant only (like the "
                    "reference, back_propagation.py:127-225); use a "
                    "single-det trial or the mixed estimator's RDMs"
                )
        if bp_opts is not None:
            self.nbp = int(round(bp_opts.get("tau_bp", 0) / qmc.dt))
            self.bp_nsplit = int(bp_opts.get("nsplit", 1))
            if self.nbp % self.bp_nsplit:
                raise ValueError("nsplit must divide tau_bp/dt")
            self.bp_restore = bp_opts.get("restore_weights", None)
            self.bp_two_rdm = bp_opts.get("two_rdm", None)
            self.bp_eval_energy = bp_opts.get("evaluate_energy", True)
            self.bp_eval_ekt = bp_opts.get("evaluate_ekt", False)
            nprop_tot = self.nbp
        else:
            self.nbp = 0
            self.bp_nsplit = 1
            self.bp_restore = None
            self.bp_two_rdm = None
            self.bp_eval_energy = False
            self.bp_eval_ekt = False
            nprop_tot = None

        # ITCF configuration (estimators/itcf.py:79-96).
        itcf_opts = eopts.get("itcf")
        if itcf_opts is not None:
            self.nitcf = int(round(itcf_opts.get("tau_max", 0) / qmc.dt))
            neqlb = int(round(itcf_opts.get("tau_eqlb", 0) / qmc.dt))
            self.itcf_stable = itcf_opts.get("stable", True)
            self.itcf_restore = itcf_opts.get("restore_weights", True)
            self.itcf_stack_size = int(itcf_opts.get("stack_size", 1))
            if self.nitcf % self.itcf_stack_size:
                raise ValueError("itcf stack_size must divide tau_max/dt")
            itcf_nprop = self.nitcf + neqlb
            if nprop_tot is not None and nprop_tot != itcf_nprop:
                raise ValueError(
                    "with both BP and ITCF enabled, tau_bp must equal "
                    "tau_max + tau_eqlb (shared field-config buffer)"
                )
            nprop_tot = itcf_nprop
        else:
            self.nitcf = 0
            self.itcf_stable = True
            self.itcf_restore = True
            self.itcf_stack_size = 1
        self.nprop_tot = nprop_tot or 0

        seed0 = qmc.rng_seed if qmc.rng_seed is not None else 7
        phonon_mw = (
            ham.m * ham.w0 if getattr(trial, "shift", None) is not None else None
        )
        self.state = walker_state.init_walkers(
            trial,
            qmc.nwalkers,
            total_weight=float(qmc.nwalkers),
            nprop_tot=nprop_tot,
            nfields=ham.nfields if nprop_tot else None,
            itcf=bool(self.nitcf),
            phonon_mw=phonon_mw,
            phonon_key=jax.random.key(seed0 + 1000003),
        )
        self.eshift = 0.0

        mixed_opts = eopts.get("mixed", {})
        self.energy_eval_freq = mixed_opts.get("energy_eval_freq", qmc.nsteps)
        # Per-step density-matrix accumulation (mixed.py:76-77 one_rdm /
        # two_rdm options; two_rdm='structure_factor' is UEG S(k)).
        self.calc_one_rdm = bool(mixed_opts.get("one_rdm", False))
        self.calc_two_rdm = mixed_opts.get("two_rdm", None)
        dms_shapes = []
        if self.calc_one_rdm:
            dms_shapes.append(("one_rdm", (2, ham.nbasis, ham.nbasis)))
        if self.calc_two_rdm is not None:
            mixed.dms_size(ham, False, self.calc_two_rdm)  # validate
            dms_shapes.append(("two_rdm", (2, 2, ham.nq)))
        from pauxy_jax.utils.io import resolve_estimates_filename

        # None after resolution: no output file (filename=False).
        filename = resolve_estimates_filename(eopts, filename)
        self.filename = filename
        create_estimates_file(
            filename,
            mixed.HEADER,
            metadata=self._metadata(popts),
        )
        self.reporter = mixed.MixedReporter(
            qmc.nsteps,
            output=H5EstimatorHelper(filename, "basic"),
            verbose=verbose,
            dms_shapes=dms_shapes,
        )
        if self.nbp:
            from pauxy_jax.estimators.back_prop import BPReporter

            from pauxy_jax.estimators.back_prop import bp_two_rdm_size

            two_rdm_shape = None
            if self.bp_two_rdm == "structure_factor":
                two_rdm_shape = (2, 2, ham.nq)
            elif self.bp_two_rdm == "full":
                two_rdm_shape = (ham.nbasis,) * 4
            bp_two_rdm_size(ham, self.bp_two_rdm)  # validate
            self.bp_reporter = BPReporter(
                H5EstimatorHelper(filename, "back_propagated"),
                self.nbp,
                self.bp_eval_energy,
                nsplit=self.bp_nsplit,
                two_rdm_shape=two_rdm_shape,
            )
        if self.nitcf:
            from pauxy_jax.estimators.itcf import ITCFReporter

            kdims = None
            if itcf_opts.get("kspace", False):
                nx = getattr(ham, "nx", None)
                kdims = (nx, ham.ny) if nx else None
            self.itcf_reporter = ITCFReporter(
                H5EstimatorHelper(filename, "itcf"), kspace_dims=kdims,
                mode=itcf_opts.get("mode", "full"),
            )

        seed = qmc.rng_seed if qmc.rng_seed is not None else 7
        self.key = jax.random.key(seed)
        self.step = 0

        # Lanes-layout fast block (qmc/hubbard_fast.py): same physics and
        # RNG stream as the generic fused block, walker axis on the vector
        # lanes. Opt out with PAUXY_FAST=0.
        from pauxy_jax.qmc import hubbard_fast

        self.use_fast_block = (
            _os.environ.get("PAUXY_FAST", "1") != "0"
            and self.block_mode == "fused"
            and hubbard_fast.eligible(
                ham, trial, self.prop,
                free_projection=self.free_projection,
                nbp=self.nbp, nitcf=self.nitcf,
                calc_one_rdm=self.calc_one_rdm,
                calc_two_rdm=self.calc_two_rdm,
                pop_method=qmc.pop_control_method,
            )
        )

        # Walker restart (handler.py:144-157 write_freq/read_file options).
        wopts = dict(walker_options or {})
        self.write_freq = wopts.get("write_freq", 0)
        self.write_file = wopts.get("write_file", "restart.h5")
        read_file = wopts.get("read_file")
        if read_file is not None:
            from pauxy_jax.utils.checkpoint import load_walkers

            self.state, info = load_walkers(self.state, read_file)
            self.step = info["step"]
            self.eshift = info["eshift"]
            if info["rng_key"] is not None:
                self.key = info["rng_key"]
            if verbose:
                print(f"# Restarted {self.state.nwalkers} walkers from "
                      f"{read_file} at step {self.step}.")
        self.timing["setup"] = time.time() - self._t_init

    # ------------------------------------------------------------------
    def _build_propagator(self, popts: dict):
        name = self.ham.name
        hs = popts.get("hubbard_stratonovich", "continuous")
        from pauxy_jax.models.ghf import GHFTrial

        if isinstance(self.trial, GHFTrial) and "discrete" not in hs:
            # The reference only pairs GHF trials with the discrete Hirsch
            # propagator (pauxy/propagation/hubbard.py:87-90).
            raise NotImplementedError(
                "GHF trials require hubbard_stratonovich='discrete'"
            )
        if name == "HubbardHolstein":
            from pauxy_jax.propagation.hirsch_dmc import make_hirsch_dmc

            return make_hirsch_dmc(
                self.ham, self.trial, self.qmc.dt,
                lang_firsov=popts.get("lang_firsov", False),
                symmetric_trotter=popts.get("symmetric_trotter", False),
                precision=self.prec,
            )
        if "discrete" in hs:
            # Discrete Hirsch propagator (propagation/utils.py:8-45 dispatch).
            if name != "Hubbard":
                raise NotImplementedError(
                    f"no discrete propagator for system {name!r}"
                )
            from pauxy_jax.propagation.hirsch import make_hirsch

            return make_hirsch(
                self.ham,
                self.trial,
                self.qmc.dt,
                charge_decomposition=popts.get("charge_decomposition", False),
                free_projection=self.free_projection,
                precision=self.prec,
                # 'single_site_update': false is the reference's spelling
                # for the whole-lattice dynamic-force-bias update
                # (propagation/hubbard.py:49).
                two_body_mode=popts.get(
                    "two_body_update",
                    "single_site" if popts.get("single_site_update", True)
                    else "direct"),
                kinetic_kspace=popts.get("kinetic_kspace", False),
                sweep_kernel=popts.get("sweep_kernel"),
            )
        if name == "Hubbard":
            from pauxy_jax.propagation.hubbard import make_hubbard_continuous

            inner = make_hubbard_continuous(
                self.ham,
                self.trial,
                self.qmc.dt,
                charge_decomposition=popts.get("charge_decomposition", True),
                precision=self.prec,
            )
        elif name == "Generic":
            from pauxy_jax.propagation.generic import make_generic_continuous

            inner = make_generic_continuous(
                self.ham, self.trial, self.qmc.dt, precision=self.prec,
                taylor_impl=popts.get("taylor_impl"),
            )
        elif name == "UEG":
            from pauxy_jax.propagation.planewave import make_planewave

            inner = make_planewave(
                self.ham, self.trial, self.qmc.dt, precision=self.prec
            )
        elif name == "PW_FFT":
            from pauxy_jax.propagation.pw_fft import make_pw_fft_inner

            inner = make_pw_fft_inner(
                self.ham, self.trial, self.qmc.dt,
                exp_order=popts.get("expansion_order", 6),
                precision=self.prec,
            )
        else:
            raise NotImplementedError(f"no propagator for system {name!r}")
        return continuous.Continuous(
            inner=inner,
            dt=self.qmc.dt,
            free_projection=self.free_projection,
            hybrid=self.hybrid,
            force_bias=popts.get("force_bias", not self.free_projection),
            # Reduced-scaling one-body application (reference option at
            # continuous.py:24-28; live here, dead code there).
            stochastic_ri=popts.get("stochastic_ri", False),
            ri_nsamples=int(popts.get("nsamples", 20)),
        )

    def _metadata(self, popts: dict) -> dict:
        from pauxy_jax.utils.io import get_sys_info

        return {
            "uuid": self.uuid,
            "sys_info": get_sys_info(),
            "system": {
                "name": self.ham.name,
                "nup": self.ham.nup,
                "ndown": self.ham.ndown,
                "nbasis": self.ham.nbasis,
            },
            "qmc": {
                "nwalkers": self.qmc.nwalkers,
                "dt": self.qmc.dt,
                "nsteps": self.qmc.nsteps,
                "nblocks": self.qmc.nblocks,
                "nstblz": self.qmc.nstblz,
                "npop_control": self.qmc.npop_control,
                "rng_seed": self.qmc.rng_seed,
            },
            "trial": {"name": self.trial.name, "etrial": self.trial.etrial},
            "propagators": {
                "free_projection": self.free_projection,
                "hybrid": self.hybrid,
            },
            "estimators": {
                "mixed": {"energy_eval_freq": self.energy_eval_freq},
                # Nested like the reference's serialized handler so
                # extraction.get_param finds the BP splits
                # (analysis/extraction.py:40-42).
                "estimators": {"back_prop": {"splits": [[
                    (i + 1) * (self.nbp // self.bp_nsplit)
                    for i in range(self.bp_nsplit)
                ]]}},
            },
        }

    # ------------------------------------------------------------------
    def _run_block_split(self, block_key, eshift):
        """Python-loop block with small per-piece jits, incl. BP/ITCF —
        same schedule as the fused program (one_step above), so fused and
        split blocks are interchangeable on backends that reject the large
        fused program."""
        from pauxy_jax.propagation.hirsch import Hirsch

        state = self.state
        qmc = self.qmc
        discrete = isinstance(self.prop, Hirsch)
        nhist = self.nprop_tot or self.nbp
        splits = ()
        if self.nbp:
            splits = tuple((i + 1) * (self.nbp // self.bp_nsplit)
                           for i in range(self.bp_nsplit))
        acc = None
        bp_acc = None
        itcf_acc = None
        for i in range(qmc.nsteps):
            step = self.step + 1 + i
            key = jax.random.fold_in(block_key, i)
            kprop, kpop, kest = jax.random.split(key, 3)
            if step % qmc.nstblz == 0:
                t0 = time.time()
                state = _step_ortho(state, self.free_projection)
                jax.block_until_ready(state.weight)
                self.timing["ortho"] += time.time() - t0
            t0 = time.time()
            bp_ix = ((step - 1) % nhist) if nhist else None
            state = _step_propagate(self.prop, self.trial, state, kprop,
                                    eshift, ham=self.ham, bp_ix=bp_ix,
                                    with_bp=bool(nhist))
            if step > 1:
                state = _step_cap(state)
            jax.block_until_ready(state.weight)
            self.timing["prop"] += time.time() - t0
            if step % qmc.npop_control == 0:
                t0 = time.time()
                state = _step_pop(
                    state, kpop, float(qmc.nwalkers), qmc.pop_control_method
                )
                jax.block_until_ready(state.weight)
                self.timing["pop"] += time.time() - t0
            t0 = time.time()
            a = _step_mixed(
                self.ham, self.trial, state,
                step % self.energy_eval_freq == 0, self.free_projection,
                self.calc_one_rdm, self.calc_two_rdm, est_key=kest,
            )
            acc = a if acc is None else acc + a

            if self.nbp:
                buffcount = (step - 1) % nhist + 1
                measured = {
                    k: _step_bp(
                        self.ham, self.trial, self.prop, state,
                        nstblz=qmc.nstblz, restore_weights=self.bp_restore,
                        discrete=discrete, eval_ekt=self.bp_eval_ekt,
                        eval_energy=self.bp_eval_energy, nbp_len=s,
                        calc_two_rdm=self.bp_two_rdm,
                    )
                    for k, s in enumerate(splits)
                    if buffcount == s
                }
                if measured:
                    template = next(iter(measured.values()))
                    parts = [measured.get(k, jnp.zeros_like(template))
                             for k in range(len(splits))]
                    cat = jnp.concatenate(parts, axis=-1)
                    bp_acc = cat if bp_acc is None else bp_acc + cat
                if buffcount == splits[-1]:
                    state = _reset_history_bp(state)

            if self.nitcf and step % nhist == 0:
                a_itcf = _step_itcf(
                    self.prop, self.trial, state,
                    nmax=self.nitcf, nstblz=qmc.nstblz,
                    stable=self.itcf_stable,
                    restore_weights=self.itcf_restore, discrete=discrete,
                    stack_size=self.itcf_stack_size,
                )
                itcf_acc = a_itcf if itcf_acc is None else itcf_acc + a_itcf
                state = _reset_history_itcf(state)

            jax.block_until_ready(acc)
            self.timing["estim"] += time.time() - t0
        self.state = state
        z = jnp.zeros((2, 0), acc.dtype)
        if self.nbp and bp_acc is None:
            from pauxy_jax.estimators.back_prop import bp_two_rdm_size

            nacc_bp = (4 + 2 * self.ham.nbasis ** 2
                       + bp_two_rdm_size(self.ham, self.bp_two_rdm)
                       + (2 * self.ham.nbasis ** 2 if self.bp_eval_ekt else 0))
            bp_acc = jnp.zeros((2, nacc_bp * self.bp_nsplit), acc.dtype)
        if self.nitcf and itcf_acc is None:
            m = self.ham.nbasis
            ntau = self.nitcf // self.itcf_stack_size
            itcf_acc = jnp.zeros(
                (2, 1 + (ntau + 1) * 4 * m * m), acc.dtype
            )
        return acc, bp_acc if bp_acc is not None else z, (
            itcf_acc if itcf_acc is not None else z
        )

    def run_block(self):
        """Advance one block (nsteps) and report."""
        self.key, sub = jax.random.split(self.key)
        if (getattr(self.prop, "sweep_kernel", "scan") != "scan"
                and len(self.state.phia.sharding.device_set) > 1):
            # The site-sweep kernel runs one device's walkers; a walker
            # axis spread over several devices takes the scan sweep.
            self.prop = self.prop.replace(sweep_kernel="scan")
        if self.block_mode == "split":
            eshift_dev = device_scalar(self.eshift, self.state.log_ovlp.dtype)
            acc, bp_acc, itcf_acc = self._run_block_split(sub, eshift_dev)
            self.step += self.qmc.nsteps

            def fetch(x):
                ri = np.asarray(x)
                return ri[0] + 1j * ri[1]

            row = self.reporter.block_row(self.step, fetch(acc))
            if self.nbp:
                self.bp_reporter.block_row(fetch(bp_acc), self.ham.nbasis)
            if self.nitcf:
                self.itcf_reporter.block_row(
                    fetch(itcf_acc), self.ham.nbasis,
                    self.nitcf // self.itcf_stack_size,
                )
            if self.step < self.qmc.neqlb:
                self.eshift = self.reporter.get_shift(self.hybrid)
            else:
                self.eshift = self.reporter.get_shift()
            return row

        if self.use_fast_block:
            from pauxy_jax.qmc import hubbard_fast

            t_block = time.time()
            self.state, acc = hubbard_fast.run_block_lanes(
                self.ham, self.trial, self.prop, self.state, sub,
                device_scalar(self.eshift, self.state.log_ovlp.dtype),
                jnp.asarray(self.step, jnp.int32),
                nsteps=self.qmc.nsteps,
                nstblz=self.qmc.nstblz,
                npop_control=self.qmc.npop_control,
                pop_method=self.qmc.pop_control_method,
                target_weight=float(self.qmc.nwalkers),
                energy_eval_freq=self.energy_eval_freq,
            )
            jax.block_until_ready(acc)
            self.timing["block"] += time.time() - t_block
            self.step += self.qmc.nsteps

            def fetch(x):
                ri = np.asarray(x)
                return ri[0] + 1j * ri[1]

            row = self.reporter.block_row(self.step, fetch(acc))
            if self.step < self.qmc.neqlb:
                self.eshift = self.reporter.get_shift(self.hybrid)
            else:
                self.eshift = self.reporter.get_shift()
            if self.write_freq and (
                self.step // self.qmc.nsteps
            ) % self.write_freq == 0:
                from pauxy_jax.utils.checkpoint import save_walkers

                save_walkers(self.state, self.write_file, key=self.key,
                             step=self.step, eshift=self.eshift)
            return row

        t_block = time.time()
        self.state, acc, bp_acc, itcf_acc = run_block(
            self.ham,
            self.trial,
            self.prop,
            self.state,
            sub,
            device_scalar(self.eshift, self.state.log_ovlp.dtype),
            jnp.asarray(self.step, jnp.int32),
            nsteps=self.qmc.nsteps,
            nstblz=self.qmc.nstblz,
            npop_control=self.qmc.npop_control,
            pop_method=self.qmc.pop_control_method,
            target_weight=float(self.qmc.nwalkers),
            energy_eval_freq=self.energy_eval_freq,
            free_projection=self.free_projection,
            calc_one_rdm=self.calc_one_rdm,
            calc_two_rdm=self.calc_two_rdm,
            nbp=self.nbp,
            bp_nsplit=self.bp_nsplit,
            bp_restore=self.bp_restore,
            bp_two_rdm=self.bp_two_rdm,
            bp_eval_energy=self.bp_eval_energy,
            bp_eval_ekt=self.bp_eval_ekt,
            nprop_tot=self.nprop_tot,
            nitcf=self.nitcf,
            itcf_stable=self.itcf_stable,
            itcf_restore=self.itcf_restore,
            itcf_stack_size=self.itcf_stack_size,
        )
        jax.block_until_ready(acc)
        self.timing["block"] += time.time() - t_block
        self.step += self.qmc.nsteps

        def fetch(x):
            ri = np.asarray(x)
            return ri[0] + 1j * ri[1]

        row = self.reporter.block_row(self.step, fetch(acc))
        if self.nbp:
            self.bp_reporter.block_row(fetch(bp_acc), self.ham.nbasis)
        if self.nitcf:
            self.itcf_reporter.block_row(
                fetch(itcf_acc), self.ham.nbasis,
                self.nitcf // self.itcf_stack_size,
            )
        # eshift follows the latest block estimate (afqmc.py:251-254).
        if self.step < self.qmc.neqlb:
            self.eshift = self.reporter.get_shift(self.hybrid)
        else:
            self.eshift = self.reporter.get_shift()
        if self.write_freq and (self.step // self.qmc.nsteps) % self.write_freq == 0:
            from pauxy_jax.utils.checkpoint import save_walkers

            save_walkers(self.state, self.write_file, key=self.key,
                         step=self.step, eshift=self.eshift)
        return row

    def run(self):
        """Run all blocks (``afqmc.py:200-255``). With ``profile_dir`` the
        whole run is captured as a JAX profiler trace (viewable in
        TensorBoard/XProf) — the counterpart of the reference's per-phase
        timer table (``afqmc.py:257-279``), which is also printed."""
        if self.verbose:
            self.reporter.print_header()
        def step(_):
            row = self.run_block()
            check_population_alive(self.state.weight,
                                   "reduce dt or improve the trial")
            return row

        if self.profile_dir:
            with jax.profiler.trace(self.profile_dir):
                rows = [step(b) for b in range(self.qmc.nblocks)]
        else:
            rows = [step(b) for b in range(self.qmc.nblocks)]
        if self.verbose:
            self.finalise()
        return np.array(rows)

    def get_energy(self, skip: int = 0):
        """Reblocked mixed-energy estimate from the output file:
        (mean, standard error), or None if too little data
        (``pauxy/qmc/afqmc.py:297-313``)."""
        if self.filename is None:
            raise ValueError("get_energy reads the estimates file, and this "
                             "run wrote none (filename=False)")
        from pauxy_jax.analysis import blocking
        from pauxy_jax.analysis.extraction import extract_mixed_estimates

        try:
            frame = extract_mixed_estimates(self.filename, skip)
            s = blocking.reblock_summary(
                np.asarray(frame.ETotal.values, dtype=complex).real
            )
            return float(s["mean"]), float(s["standard error"])
        except (IndexError, ValueError, KeyError):
            return None

    def get_one_rdm(self, skip: int = 0):
        """Block-averaged back-propagated 1-RDM (av, err), or the mixed
        1-RDM when BP is off but mixed one_rdm output is on; None otherwise
        (``pauxy/qmc/afqmc.py:323-339``)."""
        from pauxy_jax.analysis import blocking

        try:
            if self.nbp:
                return blocking.average_rdm(self.filename, skip=max(skip, 1),
                                            est_type="back_propagated",
                                            ix=self.nbp)
            if self.calc_one_rdm:
                return blocking.average_rdm(self.filename, skip=max(skip, 1),
                                            est_type="basic", ix=None)
        except (IndexError, ValueError, KeyError):
            return None
        return None

    def finalise(self, verbose: bool = True):
        """Print the timing breakdown (``afqmc.py:260-279``). In fused
        mode the block is one XLA program, so per-phase numbers exist only
        when block_mode='split' (or PAUXY_SPLIT=1)."""
        if not verbose:
            return
        t = self.timing
        nsteps = max(self.step, 1)
        print(f"# Running time : {time.time() - self._t_init:.6f} seconds")
        print("# Timing breakdown (per step):")
        print(f"# - Setup: {t['setup']:.6f} s")
        nblocks = max(self.step // max(self.qmc.nsteps, 1), 1)
        if self.block_mode == "split":
            nstblz = max(self.step // max(self.qmc.nstblz, 1), 1)
            npcon = max(self.step // max(self.qmc.npop_control, 1), 1)
            print(f"# - Orthogonalisation: {t['ortho'] / nstblz:.6f} s")
            print(f"# - Propagation: {t['prop'] / nsteps:.6f} s")
            print(f"# - Population control: {t['pop'] / npcon:.6f} s")
            print(f"# - Estimators: {t['estim'] / nsteps:.6f} s")
        else:
            print(f"# - Block (fused jit): {t['block'] / nblocks:.6f} s"
                  f" ({t['block'] / nsteps:.6f} s/step)")
