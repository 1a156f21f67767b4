"""Population control as fixed-shape collectives + gathers.

The reference implements branching with root-computed parent indices,
broadcast, and ragged point-to-point sends of serialized walker buffers
(``pauxy/walkers/handler.py:225-412``). Here the walker population is a
dense pytree, so branching is a *permutation/duplication gather*: compute a
parent index per walker slot, then ``tree_map(lambda x: x[parents], state)``.
Under a sharded walker axis XLA lowers the gather to all-to-all traffic
between the devices — no hand-written comm.

Both of the reference's algorithms are provided:

* ``comb``  — Booth & Gubernatis systematic resampling
  (``handler.py:256-338``).
* ``pair_branch`` — global sort, pair smallest/largest weights
  (``handler.py:340-412``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pauxy_jax.walkers.state import WalkerState


def _gather_walkers(state, parents: jax.Array):
    """Replace walker i by a copy of walker parents[i] (weights handled by
    the caller).

    The dense-gather equivalent of the reference's walker buffer
    serialization + Isend/Recv (walker.py:63-131, handler.py:301-327): every
    per-walker array field — including BP field-config history or thermal
    propagator stacks — moves with its parent. Works for any walker-state
    pytree whose per-walker arrays lead with the walker axis (scalars like
    total_weight pass through untouched).
    """
    nw = parents.shape[0]

    def g(x):
        if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == nw:
            return x[parents]
        return x

    return jax.tree_util.tree_map(g, state)


def comb_parents(weight: jax.Array, key: jax.Array, target_weight: float):
    """Parent slot per walker for systematic (comb) resampling.

    Layout-agnostic core (shared by the [w, ...] state path and the
    lanes-last fast path): returns (parents [w] int, total weight []).
    """
    nw = weight.shape[0]
    w = jnp.abs(weight)
    total = jnp.sum(w)
    # An all-dead population must stay dead (the reference ABORTS on
    # vanishing total weight, handler.py:236-241; in-jit we keep the dead
    # state honest instead of dividing by zero / resurrecting walkers).
    safe_total = jnp.where(total > 0, total, 1.0)
    # Rescale so the population sums to target_weight (handler.py:236-246).
    wsc = w * (target_weight / safe_total)
    cum = jnp.cumsum(wsc)
    r = jax.random.uniform(key, (), dtype=w.dtype)
    teeth = (jnp.arange(nw, dtype=w.dtype) + r) * (target_weight / nw)
    parents = jnp.clip(jnp.searchsorted(cum, teeth, side="right"), 0, nw - 1)
    parents = jnp.where(total > 0, parents, jnp.arange(nw))
    return parents, total


def comb(state: WalkerState, key: jax.Array, target_weight: float) -> WalkerState:
    """Systematic (comb) resampling of the walker population.

    Teeth at ``(i + r) * total/nw`` against the cumulative weight
    distribution; walker slot i is repopulated from the parent whose
    cumulative interval contains tooth i. Equivalent to the reference's
    parent-count construction at ``handler.py:269-291`` (the reference then
    moves clones into killed slots; a gather produces the same multiset).

    All weights are reset to 1 afterwards (``handler.py:337-338``); the
    pre-scaling weight is kept in ``unscaled_weight`` for the WeightFactor
    column (``handler.py:244-246``).
    """
    parents, total = comb_parents(state.weight, key, target_weight)
    new = _gather_walkers(state, parents)
    alive = (total > 0).astype(state.weight.dtype)
    return new.replace(
        weight=alive * jnp.ones_like(state.weight),
        unscaled_weight=state.weight,
        total_weight=total,
    )


def pair_branch(
    state: WalkerState,
    key: jax.Array,
    target_weight: float,
    min_weight: float = 0.1,
    max_weight: float = 4.0,
) -> WalkerState:
    """Pair-branch population control, fixed-shape.

    Sort walkers by |weight|; pair the s-th smallest with the s-th largest;
    where the smallest is below ``min_weight`` (or largest above
    ``max_weight``) one of the pair is cloned over the other with probability
    proportional to its weight, both receiving half the pair weight.
    Reference: ``handler.py:340-412``.
    """
    parents, new_w, total = pair_branch_parents(
        state.weight, key, target_weight, min_weight, max_weight
    )
    new = _gather_walkers(state, parents)
    return new.replace(
        weight=new_w,
        unscaled_weight=state.weight,
        total_weight=total,
    )


def pair_branch_parents(weight, key, target_weight: float,
                        min_weight: float = 0.1, max_weight: float = 4.0):
    """Layout-agnostic pair-branch core: (parents [w], new weights [w],
    total [])."""
    state_weight = weight
    nw = state_weight.shape[0]
    w = jnp.abs(state_weight)
    total = jnp.sum(w)
    # See comb_parents: a dead population stays dead, without NaNs.
    wsc = w * (target_weight / jnp.where(total > 0, total, 1.0))

    order = jnp.argsort(wsc)                     # ascending
    ws = wsc[order]
    half = nw // 2
    small = ws[:half]                            # s = 0..half-1
    large = ws[::-1][:half]                      # e = nw-1..nw-half
    pair_w = small + large

    # Branch this pair? (handler.py:352-355) — prefix-AND so only a
    # contiguous head of pairs branches, like the while loop.
    want = (small < min_weight) | (large > max_weight)
    active = jnp.cumprod(want.astype(jnp.int32)).astype(bool)

    # Clone large with prob large/pair (handler.py:356-375); a fully dead
    # pair (weight 0) clones nothing and stays at weight 0.
    u = jax.random.uniform(key, (half,), dtype=w.dtype)
    clone_large = u < large / jnp.where(pair_w > 0, pair_w, 1.0)

    new_small = jnp.where(active, 0.5 * pair_w, small)
    new_large = jnp.where(active, 0.5 * pair_w, large)

    small_idx = order[:half]
    large_idx = order[::-1][:half]
    # Parent of each slot: itself unless it lost its pair lottery.
    parents = jnp.arange(nw)
    parents = parents.at[small_idx].set(
        jnp.where(active & clone_large, large_idx, small_idx)
    )
    parents = parents.at[large_idx].set(
        jnp.where(active & ~clone_large, small_idx, large_idx)
    )
    new_w = jnp.asarray(wsc)
    new_w = new_w.at[small_idx].set(new_small)
    new_w = new_w.at[large_idx].set(new_large)
    return parents, new_w, total


def pop_control(state, key, target_weight: float, method: str = "comb"):
    if method == "comb":
        return comb(state, key, target_weight)
    if method == "pair_branch":
        return pair_branch(state, key, target_weight)
    raise ValueError(f"unknown population control method {method!r}")
