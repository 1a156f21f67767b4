"""Finite-temperature walker state: batched propagator stacks.

Batched counterpart of ``pauxy/walkers/stack.py:129-325`` (PropagatorStack
full-rank path) and ``pauxy/walkers/thermal.py:12-545`` (ThermalWalker). The
per-walker stack of binned B-matrix products is one dense array
[w, nbins, 2, M, M]; the within-bin 'left' (trial) factors are deterministic
and precomputed on the trial (models/thermal_trial.py), so only the 'right'
(stochastic) partial product is walker state.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from pauxy_jax.utils import pytree as struct

from pauxy_jax.estimators import thermal as th
from pauxy_jax.ops import clinalg


@struct.dataclass
class ThermalWalkerState:
    stack: jax.Array        # [w, nbins, 2, M, M] binned B products
    right: jax.Array        # [w, 2, M, M] partial product of active bin
    G: jax.Array            # [w, 2, M, M] current Green's function
    log_m0: jax.Array       # [w, 2] complex log det G per spin
    weight: jax.Array       # [w]
    unscaled_weight: jax.Array
    phase: jax.Array        # [w] complex
    total_weight: jax.Array  # []
    # Per-walker hybrid energy of the previous slice, -(log oratio+cfb+cmf)/dt.
    # The reference computes this quantity but never stores it
    # (thermal_propagation/continuous.py:241), leaving its EHybrid column 0;
    # here it is reported.
    hybrid_energy: jax.Array | None = None
    # Prefix-cached QDT fold over the FINALIZED bins 0..block-1 of the
    # current beta sweep ([w, 2, M, M] / [w, 2, M] / [w, 2, M, M]). Bins
    # below the active one never change until the next sweep, so their
    # fold is computed once per bin entry instead of once per slice —
    # (nbins+1)/2 average folds per slice instead of nbins. None until
    # the propagator opts in (propagation/thermal.py:propagate).
    pq: jax.Array | None = None
    pd: jax.Array | None = None
    pt: jax.Array | None = None

    @property
    def nwalkers(self) -> int:
        return self.stack.shape[0]

    @property
    def nbins(self) -> int:
        return self.stack.shape[1]

    @property
    def nbasis(self) -> int:
        return self.stack.shape[-1]


def greens_function(stack: jax.Array):
    """G = (1+A)^-1 per spin from the stack, A = stack[nbins-1]...stack[0].

    Natural bin order (index 0 rightmost), matching the reference's
    end-of-path evaluation (walkers/thermal.py:472-489 with
    slice_ix = ntime_slices). Returns (G [w,2,M,M], log det G [w,2]).
    """
    # Fold spin into the batch for the stratified product. The log-det
    # comes from the QDT factors — eliminating the assembled G directly
    # underflows to -inf once cond(G) ~ e^{beta W} passes f64 pivoting
    # (see estimators/thermal.greens_function_qdt_logdet).
    s = jnp.swapaxes(stack, 1, 2)                         # [w, 2, nbins, M, M]
    return th.greens_function_qdt_logdet(s)               # [w, 2, M, M], [w, 2]


@functools.partial(jax.jit, static_argnames=("nwalkers",))
def init_thermal_walkers(trial, nwalkers: int) -> ThermalWalkerState:
    """All stacks initialised to the trial density matrix; weight 1.

    Reference: ``stack.py:230-252`` set_all + ``handler.py:423-429`` reset.
    """
    m = trial.nbasis
    nbins = trial.nbins
    cdtype = trial.dmat.dtype
    rdtype = jnp.zeros((), cdtype).real.dtype
    stack = jnp.broadcast_to(
        trial.bin_full[None, None], (nwalkers, nbins, 2, m, m)
    ).astype(cdtype)
    right = jnp.broadcast_to(
        jnp.eye(m, dtype=cdtype), (nwalkers, 2, m, m)
    )
    g, log_m0 = greens_function(stack)
    pq, pd, pt = th.qdt_identity((nwalkers, 2), m, cdtype)
    return ThermalWalkerState(
        stack=stack,
        right=right,
        G=g,
        log_m0=log_m0,
        weight=jnp.ones((nwalkers,), rdtype),
        unscaled_weight=jnp.ones((nwalkers,), rdtype),
        phase=jnp.ones((nwalkers,), cdtype),
        total_weight=jnp.asarray(float(nwalkers), rdtype),
        hybrid_energy=jnp.zeros((nwalkers,), cdtype),
        pq=pq,
        pd=pd,
        pt=pt,
    )


def update_stack(trial, state: ThermalWalkerState, b: jax.Array, ts) -> ThermalWalkerState:
    """Push one slice propagator B [w, 2, M, M] at time slice ts.

    right <- B (counter==0 ? I : right);
    stack[block] <- left_table[counter] @ right   (stack.py:299-325).
    """
    ss = trial.stack_size
    block = ts // ss
    counter = ts % ss
    m = state.nbasis
    eye = jnp.eye(m, dtype=state.right.dtype)
    base = jnp.where(counter == 0, eye[None, None], state.right)
    right = jnp.einsum("wspm,wsmn->wspn", b, base, optimize=True)
    left = trial.left_table[counter]                      # [2, M, M]
    new_bin = jnp.einsum("spm,wsmn->wspn", left, right, optimize=True)
    stack = jax.lax.dynamic_update_slice_in_dim(
        state.stack, new_bin[:, None], block, axis=1
    )
    return state.replace(stack=stack, right=right)
