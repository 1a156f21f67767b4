"""Finite-temperature AFQMC driver.

Batched counterpart of ``pauxy/qmc/thermal_afqmc.py:21-258``. Each
measurement block samples one full imaginary-time path: a single jitted
``lax.scan`` over the beta/dt time slices, with per-slice weight capping and
population control, followed by a mixed thermal measurement (energy +
particle number from the 1-RDM) and a walker reset to the trial density
matrix (``handler.py:423-429``).
"""

from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from pauxy_jax import config
from pauxy_jax.estimators import mixed
from pauxy_jax.estimators.thermal import one_rdm_from_G, particle_number
from pauxy_jax.propagation.thermal import make_thermal_propagator
from pauxy_jax.qmc.options import QMCOpts
from pauxy_jax.utils.io import (H5EstimatorHelper, create_estimates_file,
                                get_sys_info)
from pauxy_jax.walkers import low_rank as lrw
from pauxy_jax.walkers import pop_control as pc
from pauxy_jax.walkers import thermal_state as tws

THERMAL_HEADER = [
    "Iteration", "WeightFactor", "Weight", "ENumer", "EDenom", "ETotal",
    "E1Body", "E2Body", "EHybrid", "Overlap", "Nav", "Time",
]


@functools.partial(
    jax.jit,
    static_argnames=(
        "ntime_slices", "npop_control", "pop_method", "target_weight",
        "calc_one_rdm", "average_gf",
    ),
)
def run_path(
    ham,
    trial,
    prop,
    state,
    path_key,
    *,
    ntime_slices: int,
    npop_control: int,
    pop_method: str,
    target_weight: float,
    calc_one_rdm: bool = False,
    average_gf: bool = False,
):
    """Propagate one full beta path and measure (thermal_afqmc.py:212-235)."""

    def one_slice(state, inp):
        ts, key = inp
        kprop, kpop = jax.random.split(key)
        state = prop.propagate(trial, state, kprop, ts)
        cap = 0.10 * state.total_weight
        state = state.replace(
            weight=jnp.where(
                (ts > 0) & (jnp.abs(state.weight) > cap), cap, state.weight
            )
        )
        state = jax.lax.cond(
            (ts % npop_control == 0) & (ts != 0),
            lambda s: pc.pop_control(s, kpop, target_weight, pop_method),
            lambda s: s,
            state,
        )
        return state, None

    keys = jax.random.split(path_key, ntime_slices)
    state, _ = jax.lax.scan(one_slice, state, (jnp.arange(ntime_slices), keys))
    return state, measure_state(ham, trial, state, calc_one_rdm, average_gf)


@functools.partial(jax.jit, static_argnames=("calc_one_rdm", "average_gf"))
def measure_state(ham, trial, state, calc_one_rdm: bool = False,
                  average_gf: bool = False):
    """Mixed thermal measurement from the current Green's function
    (estimators/mixed.py:183-208, thermal branch); works for both the
    full-rank and low-rank walker states (both carry G).

    The EHybrid column reports the tracked per-slice hybrid energy (the
    reference computes but never stores it, so its column reads 0); the
    Overlap column is Sum w |ot| with thermal ot = 1 (mixed.py:224). With
    ``calc_one_rdm``, the weighted 1-RDM P = 1 - G^T is appended flat —
    note the reference pushes the *Green's function* G there
    (mixed.py:226-229); P is the physical density matrix.
    """
    e_fn = mixed.energy_estimator_G(ham, trial)
    if average_gf and hasattr(state, "stack"):
        # tau-averaged estimator (mixed.py:182-199 average_gf): the SAME
        # full-beta path measured at every cyclic stack origin — G(origin k)
        # from the bin-rotated stratified product — then averaged.
        nbins = state.nbins

        def measure_at(k):
            from pauxy_jax.walkers import thermal_state as _tws

            rolled = jnp.roll(state.stack, -k, axis=1)
            g, _ = _tws.greens_function(rolled)
            pk = one_rdm_from_G(g)
            ek, e1k, e2k = e_fn(pk[:, 0], pk[:, 1])
            return ek, e1k, e2k, particle_number(pk), pk

        parts = [measure_at(k) for k in range(nbins)]
        etot = sum(p[0] for p in parts) / nbins
        e1b = sum(p[1] for p in parts) / nbins
        e2b = sum(p[2] for p in parts) / nbins
        nav = sum(p[3] for p in parts) / nbins
        p = sum(pp[4] for pp in parts) / nbins
    else:
        p = one_rdm_from_G(state.G)
        etot, e1b, e2b = e_fn(p[:, 0], p[:, 1])
        nav = particle_number(p)
    w = state.weight
    cdtype = state.G.dtype
    ehyb = (
        jnp.sum(w * state.hybrid_energy)
        if state.hybrid_energy is not None
        else jnp.zeros((), cdtype)
    )
    acc = jnp.stack(
        [
            jnp.sum(state.unscaled_weight).astype(cdtype),
            jnp.sum(w).astype(cdtype),
            jnp.sum(w * etot.real).astype(cdtype),
            jnp.sum(w).astype(cdtype),
            jnp.sum(w * e1b.real).astype(cdtype),
            jnp.sum(w * e2b.real).astype(cdtype),
            ehyb.astype(cdtype),
            jnp.sum(w).astype(cdtype),           # Overlap: ot = 1 at T > 0
            jnp.sum(w * nav).astype(cdtype),
        ]
    )
    if calc_one_rdm:
        rdm = jnp.einsum("w,wsmn->smn", w.astype(cdtype), p)
        acc = jnp.concatenate([acc, rdm.reshape(-1)])
    return jnp.stack([acc.real, acc.imag])


class ThermalAFQMC:
    """Finite-temperature AFQMC simulation."""

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
    ):
        assert qmc.beta is not None, "thermal run needs qmc.beta"
        self.ham = ham
        self.trial = trial
        self.qmc = qmc
        self.verbose = verbose
        self.prec = config.get_precision(precision)
        self.ntime_slices = trial.num_slices
        popts = dict(propagator_options or {})
        self.matmul_precision = config.set_matmul_precision(
            popts.get("matmul_precision")
        )
        wopts = dict(walker_options or {})
        # Low-rank QDT stack (walkers/stack.py:326-489): requires a diagonal
        # trial density matrix (stack.py:333).
        self.low_rank = bool(wopts.get("low_rank", False))
        if self.low_rank:
            from pauxy_jax.utils.transfer import to_host

            dmat = np.asarray(to_host(trial.dmat))
            off = dmat - np.stack(
                [np.diag(np.diagonal(dmat[0])), np.diag(np.diagonal(dmat[1]))]
            )
            assert np.abs(off).max() < 1e-10, (
                "low-rank stack requires a diagonal trial density matrix"
            )
            popts.setdefault("low_rank", True)
            popts.setdefault(
                "low_rank_thresh", wopts.get("low_rank_thresh", 1e-6)
            )
        if "discrete" in popts.get("hubbard_stratonovich", ""):
            # Discrete Hirsch fields (thermal_propagation/utils.py:24-33).
            from pauxy_jax.propagation.thermal_discrete import (
                make_thermal_discrete)

            self.prop = make_thermal_discrete(
                ham, trial, qmc.dt,
                charge_decomposition=popts.get("charge_decomposition", False),
                free_projection=popts.get("free_projection", False),
                mu=popts.get("mu"),
                wrap_stabilize=popts.get("wrap_stabilize", 10),
                precision=self.prec,
            )
        else:
            self.prop = make_thermal_propagator(
                ham, trial, qmc.dt, options=popts, precision=self.prec
            )
        self._init_walkers = (
            lrw.init_low_rank_walkers if self.low_rank
            else tws.init_thermal_walkers
        )
        self.state = self._init_walkers(trial, qmc.nwalkers)
        eopts = dict(estimator_options or {})
        self.calc_one_rdm = bool(
            eopts.get("mixed", {}).get("one_rdm", False)
        )
        self.average_gf = bool(
            eopts.get("mixed", {}).get("average_gf", False)
        )
        if self.average_gf and self.low_rank:
            raise NotImplementedError(
                "average_gf needs the full-rank stack (mixed.py:182-199)"
            )
        from pauxy_jax.utils.io import resolve_estimates_filename

        # None after resolution: no output file (filename=False).
        filename = resolve_estimates_filename(eopts, filename)
        self.filename = filename
        create_estimates_file(
            filename,
            THERMAL_HEADER,
            metadata={
                "sys_info": get_sys_info(),
                "system": {"name": ham.name, "nbasis": ham.nbasis},
                "qmc": {
                    "beta": qmc.beta, "dt": qmc.dt, "nwalkers": qmc.nwalkers,
                    "mu": trial.mu,
                },
                "propagators": {"free_projection": self.prop.free_projection},
                "estimators": {},
            },
        )
        self.output = H5EstimatorHelper(filename, "basic")
        seed = qmc.rng_seed if qmc.rng_seed is not None else 7
        self.key = jax.random.key(seed)
        self.block = 0
        self._t0 = time.time()

    def _emit_row(self, acc, iteration):
        ri = np.asarray(acc)
        acc = ri[0] + 1j * ri[1]
        uweight, weight, enum, edenom, e1b, e2b, ehyb, ovlp = acc[:8]
        navw = acc[8]
        now = time.time()
        elapsed, self._t0 = now - self._t0, now
        # Zero guards mirror the zero-T MixedReporter.block_row: a dead
        # block reports zeros (the driver then aborts) instead of pushing
        # a NaN row into the h5 output.
        denom = edenom if abs(edenom) > 0 else 1.0
        wsum = weight if abs(weight) > 0 else 1.0
        row = np.array(
            [
                iteration, uweight, weight, enum, edenom,
                enum / denom, e1b / denom, e2b / denom,
                ehyb / wsum, ovlp / wsum, navw / denom, elapsed,
            ],
            dtype=np.complex128,
        )
        if self.verbose:
            print("".join(f"{v.real: 16.8e} " for v in row))
        self.output.push(row, "energies")
        if self.calc_one_rdm:
            m = self.ham.nbasis
            rdm = acc[9 : 9 + 2 * m * m].reshape(2, m, m) / denom
            self.output.push(rdm, "one_rdm")
        self.output.increment()
        return row

    def run_block(self):
        self.key, sub = jax.random.split(self.key)
        self.state, acc = run_path(
            self.ham,
            self.trial,
            self.prop,
            self.state,
            sub,
            ntime_slices=self.ntime_slices,
            npop_control=self.qmc.npop_control,
            pop_method=self.qmc.pop_control_method,
            target_weight=float(self.qmc.nwalkers),
            calc_one_rdm=self.calc_one_rdm,
            average_gf=self.average_gf,
        )
        self.block += 1
        # Liveness BEFORE the per-block reset (the reference's pop-control
        # abort on sum(|w|), walkers/handler.py:236-241).
        from pauxy_jax.qmc.afqmc import check_population_alive

        check_population_alive(self.state.weight, "reduce dt or beta")
        row = self._emit_row(acc, self.block)
        # Reset to the trial density matrix for the next independent path
        # (thermal_afqmc.py:235 + handler.py:423-429).
        self.state = self._init_walkers(self.trial, self.qmc.nwalkers)
        return row

    def run(self):
        if self.verbose:
            print("".join(f"{h:>17s}" for h in THERMAL_HEADER))
        rows = [self._emit_row(
            measure_state(self.ham, self.trial, self.state,
                          self.calc_one_rdm, self.average_gf), 0
        )]
        rows += [self.run_block() for _ in range(self.qmc.nblocks)]
        return np.array(rows)
