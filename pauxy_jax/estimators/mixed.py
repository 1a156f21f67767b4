"""Mixed estimator: device-side accumulation + host-side block reporting.

Batched counterpart of ``pauxy/estimators/mixed.py:33-345``. The
per-walker accumulation loop (``mixed.py:180-233``) becomes one batched
weighted reduction per step inside the jitted block program; the MPI
``comm.Reduce`` at ``mixed.py:261`` is a ``jnp.sum`` over the (possibly
mesh-sharded) walker axis. Only the formatted block row touches the host.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from pauxy_jax.estimators import local_energy as le
from pauxy_jax.ops import greens

# Accumulator column indices (cf. get_estimator_enum, mixed.py:460-489).
UWEIGHT, WEIGHT, ENUMER, EDENOM, E1B, E2B, EHYB, OVLP = range(8)
NACC = 8

HEADER = [
    "Iteration",
    "WeightFactor",
    "Weight",
    "ENumer",
    "EDenom",
    "ETotal",
    "E1Body",
    "E2Body",
    "EHybrid",
    "Overlap",
    "Time",
]


def energy_estimator(ham, trial, key=None):
    """Return a batched ``(ga, gb) -> (etot, e1b, e2b)`` local-energy closure.

    Dispatch mirrors ``mixed.py:383-437`` incl. the Generic variants
    (exact-ERI, PNO, stochastic-RI; ``mixed.py:405-431``). ``key`` feeds the
    stochastic-RI Rademacher probes.
    """
    name = ham.name
    if name == "Hubbard":
        return lambda ga, gb: le.local_energy_hubbard(ham, ga.G, gb.G)
    if name == "Generic":
        if getattr(trial, "rchola", None) is not None and trial.rchola.ndim == 4:
            return lambda ga, gb: le.local_energy_generic_opt_multi(
                trial, ga.Ghalf, gb.Ghalf, ga.det_weights, ham.ecore
            )
        if ham.pno:
            return lambda ga, gb: le.local_energy_generic_pno(
                trial, ga.Ghalf, gb.Ghalf, ham.ecore
            )
        if ham.exact_eri:
            return lambda ga, gb: le.local_energy_generic_exact_eri(
                trial, ga.Ghalf, gb.Ghalf, ham.ecore
            )
        if ham.stochastic_ri:
            if key is None:
                raise ValueError("stochastic_ri local energy needs an RNG key")
            return lambda ga, gb: le.local_energy_generic_stochastic_ri(
                trial, ga.Ghalf, gb.Ghalf, ham.ecore, key,
                ham.nsamples, ham.control_variate,
            )
        return lambda ga, gb: le.local_energy_generic_opt(
            trial, ga.Ghalf, gb.Ghalf, ham.ecore
        )
    if name == "UEG":
        if getattr(ham, "gmap", None) is not None:
            # FFT fast path from half-rotated G (ueg_kernels.pyx:77-133).
            return lambda ga, gb: le.local_energy_ueg_half(
                ham, trial, ga.Ghalf, gb.Ghalf
            )
        return lambda ga, gb: le.local_energy_ueg(ham, ga.G, gb.G)
    if name == "PW_FFT":
        return lambda ga, gb: le.local_energy_pw_fft(
            ham, trial, ga.Ghalf, gb.Ghalf
        )
    raise NotImplementedError(f"no local energy kernel for system {name!r}")


def energy_estimator_G(ham, trial):
    """Dense-G local-energy closure ``(Ga, Gb) -> (etot, e1b, e2b)`` for
    back-propagated Green's functions (opt=False path, mixed.py:383-437)."""
    name = ham.name
    if name == "Hubbard":
        return lambda ga, gb: le.local_energy_hubbard(ham, ga, gb)
    if name == "Generic":
        return lambda ga, gb: le.local_energy_generic_cholesky_G(ham, ga, gb)
    if name == "UEG":
        return lambda ga, gb: le.local_energy_ueg(ham, ga, gb)
    raise NotImplementedError(f"no dense-G energy kernel for {name!r}")


def dms_size(ham, calc_one_rdm: bool, calc_two_rdm: str | None) -> int:
    """Flat length of the optional density-matrix tail of the accumulator
    (mirrors ``mixed.py:96-111``: one_rdm -> [2, M, M], two_rdm
    'structure_factor' -> [2, 2, nq], UEG only)."""
    n = 0
    if calc_one_rdm:
        n += 2 * ham.nbasis * ham.nbasis
    if calc_two_rdm is not None:
        if calc_two_rdm != "structure_factor" or ham.name != "UEG":
            raise NotImplementedError(
                "two_rdm accumulation supports only 'structure_factor' on "
                "the UEG (pauxy/estimators/mixed.py:101-107)"
            )
        n += 4 * ham.nq
    return n


def update(ham, trial, state, eval_energy, free_projection: bool = False,
           calc_one_rdm: bool = False, calc_two_rdm: str | None = None,
           est_key=None):
    """One step's contribution to the block accumulator, shape
    [NACC + dms_size] complex.

    Reference: ``mixed.py:133-233``. ``eval_energy`` is a traced bool —
    energy terms are gated with ``lax.cond`` so skipped steps cost nothing
    (energy_eval_freq, ``mixed.py:213-224``). With ``calc_one_rdm`` /
    ``calc_two_rdm`` the weighted per-step density matrices are appended
    flat, like the reference's estimates array (``mixed.py:226-233``) —
    accumulated on energy-eval steps (where G is freshly computed) and
    normalized by EDenom at readout.
    """
    from pauxy_jax.models.ghf import GHFTrial, ghf_greens_function
    from pauxy_jax.models.multi_slater import (
        MultiSlaterTrial,
        greens_function_multi_det,
    )

    from pauxy_jax.models.multi_coherent import (
        MultiCoherentTrial,
        mc_boson_mixture,
        mc_greens_function,
    )

    cdtype = state.log_ovlp.dtype
    # Every e_fn below is a LAZY 0-arg closure: the Green's functions and
    # energies are traced only inside the with_energy branch of the
    # lax.cond, so energy_eval_freq gating skips their cost for every
    # trial family (not just the single-det path). Duplicate sub-graphs
    # between e_fn and _dms_flat (both run inside the same branch) are
    # CSE'd by XLA.
    if isinstance(trial, MultiCoherentTrial):
        # Component-weighted electron-phonon energy (mixed.py:450-458
        # local_energy_multi_det_hh).
        def e_fn():
            gi, comp_w = mc_greens_function(trial, state.phia, state.phib,
                                            state.X)
            _, lap, _ = mc_boson_mixture(trial, state.phia, state.phib,
                                         state.X)
            return le.local_energy_multi_coherent(
                ham, gi, comp_w, state.X, lap
            )
    elif isinstance(trial, GHFTrial):
        # Det-weighted GHF energy (multi_ghf.py:206-220 via
        # estimators/hubbard.py:117-143).
        def e_fn():
            gi, det_weights = ghf_greens_function(trial, state.phia,
                                                  state.phib)
            return le.local_energy_hubbard_ghf(ham, gi, det_weights)
    elif isinstance(trial, MultiSlaterTrial):
        # Per-determinant mixed energy, det-weighted
        # (mixed.py:439-458 local_energy_multi_det).
        def get_md():
            return greens_function_multi_det(trial, state.phia, state.phib)

        def e_fn():
            md = get_md()
            if ham.name == "Generic" and trial.rchola is not None:
                # Per-det half-rotated fast path (multi_slater.py:267-420).
                return le.local_energy_generic_opt_multi(
                    trial, md.Ghalfa, md.Ghalfb, md.det_weights, ham.ecore
                )
            eg = energy_estimator_G(ham, trial)
            nw, nd = md.det_weights.shape
            m = state.phia.shape[1]
            gi = md.Gi.reshape(nw * nd, 2, m, m)
            etot_d, e1_d, e2_d = eg(gi[:, 0], gi[:, 1])

            def det_avg(x):
                return jnp.sum(md.det_weights * x.reshape(nw, nd), axis=-1)

            return (det_avg(etot_d), det_avg(e1_d), det_avg(e2_d))
    elif ham.name == "HubbardHolstein":
        def e_fn():
            ga = greens.greens_function(state.phia, trial.psia)
            gb = greens.greens_function(state.phib, trial.psib)
            return le.local_energy_hubbard_holstein(ham, ga.G, gb.G,
                                                    state.X, trial.shift)
    else:
        _e_fn_g = energy_estimator(ham, trial, key=est_key)

        def e_fn():
            ga = greens.greens_function(state.phia, trial.psia)
            gb = greens.greens_function(state.phib, trial.psib)
            return _e_fn_g(ga, gb)

    if free_projection:
        # wfac = weight * ot * phase (mixed.py:151-175).
        ot = jnp.exp(state.log_ovlp)
        wfac = state.weight * ot * state.phase
        ovlp_c = state.weight * jnp.abs(ot)
    else:
        wfac = state.weight.astype(cdtype)
        ovlp_c = state.weight * jnp.exp(state.log_ovlp.real)

    ndms = dms_size(ham, calc_one_rdm, calc_two_rdm)
    if ndms and free_projection:
        # The reference's FP path accumulates no density matrices
        # (mixed.py:151-175).
        raise NotImplementedError("RDM accumulation not defined for FP")
    if ndms and isinstance(trial, GHFTrial):
        raise NotImplementedError("GHF G is 2M x 2M; one_rdm output is spin-blocked")
    if calc_two_rdm is not None and isinstance(trial, MultiCoherentTrial):
        raise NotImplementedError("two_rdm (S(k)) is UEG-only; multi-coherent "
                                  "trials are Hubbard-Holstein")

    def _dms_flat():
        """Weighted per-step density-matrix tail (mixed.py:226-233)."""
        parts = []
        if isinstance(trial, MultiCoherentTrial):
            # Mixture 1-RDM: the reference pushes w.G where the walker's G
            # is the component-weighted mixture (multi_coherent.py:360-401);
            # comp_w is normalized so tr G_s = n_s exactly.
            gi, comp_w = mc_greens_function(trial, state.phia, state.phib,
                                            state.X)
            g2 = jnp.einsum("wp,wpsmn->wsmn", comp_w, gi, optimize=True)
        elif isinstance(trial, MultiSlaterTrial):
            md = get_md()
            g2 = jnp.einsum("wd,wdsmn->wsmn", md.det_weights, md.Gi,
                            optimize=True)
        else:
            ga = greens.greens_function(state.phia, trial.psia)
            gb = greens.greens_function(state.phib, trial.psib)
            g2 = jnp.stack([ga.G, gb.G], axis=1)          # [w, 2, M, M]
        if calc_one_rdm:
            s = jnp.einsum("w,wsmn->smn", wfac, g2.real.astype(cdtype))
            parts.append(s.reshape(-1))
        if calc_two_rdm is not None:
            # FFT pseudo-spectral S(k) from the half-rotated G whenever the
            # trial half-factorizes (single-det; VERDICT r2 item 4); the
            # gather kernels remain the general-G fallback.
            if (not isinstance(trial, MultiSlaterTrial)
                    and getattr(ham, "gmap", None) is not None):
                ga = greens.greens_function(state.phia, trial.psia)
                gb = greens.greens_function(state.phib, trial.psib)
                factors = ((trial.psia, ga.Ghalf), (trial.psib, gb.Ghalf))
            else:
                factors = ((g2[:, 0], None), (g2[:, 1], None))
            sk = le.structure_factor_ueg(ham, factors)    # [w, 2, 2, nq]
            s = jnp.einsum("w,wabq->abq", wfac, sk.real.astype(cdtype))
            parts.append(s.reshape(-1))
        return jnp.concatenate(parts)

    def with_energy(_):
        etot, e1b, e2b = e_fn()
        if free_projection:
            num = jnp.sum(wfac * etot)
            t1 = jnp.sum(wfac * e1b)
            t2 = jnp.sum(wfac * e2b)
        else:
            num = jnp.sum(wfac * etot.real)
            t1 = jnp.sum(wfac * e1b.real)
            t2 = jnp.sum(wfac * e2b.real)
        dms = _dms_flat() if ndms else jnp.zeros((0,), cdtype)
        return num, jnp.sum(wfac), t1, t2, dms

    def without_energy(_):
        z = jnp.zeros((), cdtype)
        return z, z, z, z, jnp.zeros((ndms if ndms else 0,), cdtype)

    enumer, edenom, e1b, e2b, dms = jax.lax.cond(
        eval_energy, with_energy, without_energy, None
    )

    acc = jnp.stack(
        [
            jnp.sum(state.unscaled_weight).astype(cdtype),
            jnp.sum(wfac),
            enumer,
            edenom,
            e1b,
            e2b,
            jnp.sum(wfac * state.hybrid_energy),
            jnp.sum(ovlp_c).astype(cdtype),
        ]
    )
    return jnp.concatenate([acc, dms])


class MixedReporter:
    """Host-side block normalization, stdout table and HDF5 push.

    Mirrors the normalization in ``mixed.py:235-289``.
    """

    def __init__(self, nsteps: int, output=None, verbose: bool = True,
                 dms_shapes=()):
        self.nsteps = nsteps
        self.output = output
        self.verbose = verbose
        self._t0 = time.time()
        self.eshift_hybrid = 0.0
        self.eshift_proj = 0.0
        # [(h5 dataset name, shape)] for the flat density-matrix tail
        # (mixed.py:279-287 one_rdm/two_rdm push).
        self.dms_shapes = list(dms_shapes)

    def print_header(self):
        if self.verbose:
            print("".join(f"{h:>17s}" for h in HEADER))

    def block_row(self, step: int, acc: np.ndarray) -> np.ndarray:
        """Normalize a summed block accumulator into an output row."""
        acc = np.asarray(acc)
        now = time.time()
        elapsed = now - self._t0
        self._t0 = now
        uweight = acc[UWEIGHT] / self.nsteps
        weight = acc[WEIGHT] / self.nsteps
        edenom = acc[EDENOM]
        # Guard the step-0 row where no energy was accumulated yet.
        denom = edenom if abs(edenom) > 0 else 1.0
        etotal = acc[ENUMER] / denom
        e1b = acc[E1B] / denom
        e2b = acc[E2B] / denom
        wsum = acc[WEIGHT] if abs(acc[WEIGHT]) > 0 else 1.0
        ehyb = acc[EHYB] / wsum
        ovlp = acc[OVLP] / wsum
        self.eshift_hybrid = ehyb
        self.eshift_proj = etotal
        row = np.array(
            [
                step,
                uweight,
                weight,
                acc[ENUMER],
                edenom,
                etotal,
                e1b,
                e2b,
                ehyb,
                ovlp,
                elapsed,
            ],
            dtype=np.complex128,
        )
        if self.verbose:
            print("".join(f"{v.real: 16.8e} " for v in row))
        if self.output is not None:
            self.output.push(row, "energies")
            # Density-matrix tail: normalize the weighted sum by EDenom
            # (= the weight mass of the energy-eval steps the DMs were
            # accumulated on; equals the reference's weight normalization
            # at energy_eval_freq=1, mixed.py:279-287).
            off = NACC
            for name, shape in self.dms_shapes:
                size = int(np.prod(shape))
                dm = acc[off : off + size].reshape(shape) / denom
                self.output.push(dm, name)
                off += size
            self.output.increment()
        return row

    def get_shift(self, hybrid: bool = True) -> float:
        """New eshift after a block (mixed.py:345-349)."""
        e = self.eshift_hybrid if hybrid else self.eshift_proj
        return float(np.real(e))
