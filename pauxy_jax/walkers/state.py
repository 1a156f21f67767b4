"""Struct-of-arrays walker state.

The reference keeps a Python list of walker objects with per-walker numpy
arrays and (de)serializes them into flat buffers for MPI
(``pauxy/walkers/walker.py:24-131``, ``single_det.py:11-94``). Here the whole
population is one pytree of dense arrays with a leading walker axis ``w`` —
propagation is batched linear algebra, population control is an index gather,
and multi-chip sharding is a ``NamedSharding`` over ``w``.

All overlap bookkeeping is in log space (complex ``log_ovlp``), replacing the
reference's log_shift / detR_shift machinery.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from pauxy_jax.utils import pytree as struct

from pauxy_jax.ops import greens


@struct.dataclass
class WalkerState:
    """Batched AFQMC walker population (one spin-unrestricted determinant each).

    Reference fields: ``pauxy/walkers/walker.py:24-61`` and
    ``single_det.py:31-94``.
    """

    phia: jax.Array            # [w, M, na] alpha Slater matrices
    phib: jax.Array            # [w, M, nb] beta Slater matrices
    weight: jax.Array          # [w] real walker weights
    unscaled_weight: jax.Array  # [w] real, pre-pop-control weights (reporting)
    phase: jax.Array           # [w] complex unit phase (free projection)
    log_ovlp: jax.Array        # [w] complex log <psi_T|phi>
    hybrid_energy: jax.Array   # [w] complex hybrid energy of previous step
    eloc: jax.Array            # [w] complex local energy of previous step
    log_detr: jax.Array        # [w] real accumulated log det R from reortho
    total_weight: jax.Array    # [] real global weight (set by pop control)
    # --- optional auxiliary-field history for back propagation / ITCF
    # (pauxy/walkers/stack.py:5-127 FieldConfig, as fixed dense arrays) ---
    configs: jax.Array | None = None      # [w, nprop_tot, nfields] complex
    cos_fac: jax.Array | None = None      # [w, nprop_tot] real
    weight_fac: jax.Array | None = None   # [w, nprop_tot] complex
    phia_old: jax.Array | None = None     # [w, M, na] historic wfn (BP)
    phib_old: jax.Array | None = None     # [w, M, nb]
    phia_right: jax.Array | None = None   # [w, M, na] init wfn snapshot (ITCF)
    phib_right: jax.Array | None = None   # [w, M, nb]
    X: jax.Array | None = None            # [w, M] phonon coordinates (HH)

    @property
    def nwalkers(self) -> int:
        return self.phia.shape[0]

    @property
    def nbasis(self) -> int:
        return self.phia.shape[1]


import functools


@functools.partial(
    jax.jit,
    static_argnames=("nwalkers", "total_weight", "nprop_tot", "nfields", "itcf",
                     "phonon_mw"),
)
def init_walkers(
    trial,
    nwalkers: int,
    total_weight: float | None = None,
    nprop_tot: int | None = None,
    nfields: int | None = None,
    itcf: bool = False,
    phonon_mw: float | None = None,
    phonon_key=None,
) -> WalkerState:
    """Initialise all walkers to the trial determinant with unit weight.

    Reference: ``pauxy/walkers/handler.py:115-128`` + ``walker.py:24-61``.
    ``total_weight`` seeds the weight-cap bound (reference leaves it 0 until
    the first pop-control event, ``walker.py:33``; we use the target weight so
    the cap at ``afqmc.py:235-236`` is active from the start).

    Jitted: the target backend mis-handles *eager* complex primitives (see
    utils/transfer.py), so even setup-time device math runs compiled.
    """
    from pauxy_jax.models.ghf import GHFTrial, ghf_log_overlap
    from pauxy_jax.models.multi_coherent import (
        MultiCoherentTrial,
        mc_log_overlap,
    )
    from pauxy_jax.models.multi_slater import (
        MultiSlaterTrial,
        log_overlap_multi_det,
    )

    phia = jnp.broadcast_to(trial.inita[None], (nwalkers,) + trial.inita.shape)
    phib = jnp.broadcast_to(trial.initb[None], (nwalkers,) + trial.initb.shape)
    cdtype = trial.inita.dtype
    rdtype = jnp.real(jnp.zeros((), cdtype)).dtype
    x0 = None
    if getattr(trial, "shift", None) is not None and phonon_mw is not None:
        # Sample X from |phi_B(X)|^2 = Normal(shift, 1/(2 m w0)) — the exact
        # distribution the reference approximates with a 250-step VMC walk
        # (single_det.py:39-61).
        sigma = (2.0 * phonon_mw) ** -0.5
        x0 = trial.shift[None, :] + sigma * jax.random.normal(
            phonon_key, (nwalkers, trial.shift.shape[0]), rdtype
        )
    if isinstance(trial, MultiCoherentTrial):
        log_oa = mc_log_overlap(trial, phia, phib, x0)
        log_ob = jnp.zeros_like(log_oa)
    elif isinstance(trial, GHFTrial):
        log_oa = ghf_log_overlap(trial, phia, phib)
        log_ob = jnp.zeros_like(log_oa)
    elif isinstance(trial, MultiSlaterTrial):
        log_oa = log_overlap_multi_det(trial, phia, phib)
        log_ob = jnp.zeros_like(log_oa)
    else:
        log_oa = greens.log_overlap(phia, trial.psia)
        log_ob = greens.log_overlap(phib, trial.psib)
    if total_weight is None:
        total_weight = float(nwalkers)
    extras = {}
    if nprop_tot is not None:
        # Field-config history for BP/ITCF (walker.py:53-60); cos/weight
        # factors start at 1 so untouched slots are no-ops in products.
        extras = dict(
            configs=jnp.zeros((nwalkers, nprop_tot, nfields), cdtype),
            cos_fac=jnp.ones((nwalkers, nprop_tot), rdtype),
            weight_fac=jnp.ones((nwalkers, nprop_tot), cdtype),
            phia_old=phia,
            phib_old=phib,
        )
        if itcf:
            extras.update(phia_right=phia, phib_right=phib)
    if x0 is not None:
        extras["X"] = x0
    return WalkerState(
        phia=phia,
        phib=phib,
        weight=jnp.ones((nwalkers,), rdtype),
        unscaled_weight=jnp.ones((nwalkers,), rdtype),
        phase=jnp.ones((nwalkers,), cdtype),
        log_ovlp=log_oa + log_ob,
        hybrid_energy=jnp.zeros((nwalkers,), cdtype),
        eloc=jnp.zeros((nwalkers,), cdtype),
        log_detr=jnp.zeros((nwalkers,), rdtype),
        total_weight=jnp.asarray(float(total_weight), rdtype),
        **extras,
    )


def orthogonalise(state: WalkerState, free_projection: bool = False) -> WalkerState:
    """Batched QR re-orthogonalisation of the whole population.

    Phaseless: overlap absorbs det(R) (``single_det.py:215-255``,
    ``handler.py:166-181``). Free projection: |det R| multiplies the weight
    and its phase multiplies the walker phase (``handler.py:173-181``) —
    det R is real positive here by construction, so only the weight moves.
    """
    phia, log_ra = greens.reortho(state.phia)
    phib, log_rb = greens.reortho(state.phib)
    log_r = log_ra + log_rb
    if free_projection:
        return state.replace(
            phia=phia,
            phib=phib,
            weight=state.weight * jnp.exp(log_r),
            log_detr=state.log_detr + log_r,
        )
    return state.replace(
        phia=phia,
        phib=phib,
        log_ovlp=state.log_ovlp - log_r.astype(state.log_ovlp.dtype),
        log_detr=state.log_detr + log_r,
    )
