"""Population control tests: fixed-shape comb / pair_branch semantics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pauxy_jax.models import make_hubbard, free_electron_trial
from pauxy_jax.walkers import init_walkers
from pauxy_jax.walkers import pop_control as pc


def make_state(weights):
    ham = make_hubbard(nup=2, ndown=2, U=4.0, nx=2, ny=2)
    trial = free_electron_trial(ham)
    state = init_walkers(trial, len(weights))
    # Tag each walker's phia so parents are identifiable after the gather.
    tags = jnp.arange(len(weights), dtype=state.phia.dtype)
    return state.replace(
        phia=state.phia.at[:, 0, 0].set(tags),
        weight=jnp.asarray(weights, state.weight.dtype),
    )


def walker_tag(state):
    return np.round(np.asarray(state.phia[:, 0, 0]).real).astype(int)


@pytest.mark.unit
def test_comb_weights_reset_and_total_weight():
    w = [0.5, 2.0, 1.0, 0.1]
    state = make_state(w)
    out = pc.comb(state, jax.random.key(1), target_weight=4.0)
    np.testing.assert_allclose(np.asarray(out.weight), 1.0)
    assert float(out.total_weight) == pytest.approx(sum(w))
    np.testing.assert_allclose(np.asarray(out.unscaled_weight), w)


@pytest.mark.unit
def test_comb_parent_distribution():
    """Expected number of copies of walker i is nw * w_i / sum(w)."""
    w = np.array([0.1, 3.0, 0.5, 0.4])
    state = make_state(list(w))
    counts = np.zeros(4)
    ntrial = 400
    for i in range(ntrial):
        out = pc.comb(state, jax.random.key(i), target_weight=4.0)
        tags = walker_tag(out)
        for t in tags:
            counts[t] += 1
    freq = counts / ntrial
    expected = 4.0 * w / w.sum()
    np.testing.assert_allclose(freq, expected, atol=0.15)
    # Systematic resampling: counts per draw within 1 of expectation.
    out = pc.comb(state, jax.random.key(0), target_weight=4.0)
    tags = walker_tag(out)
    for i in range(4):
        assert abs((tags == i).sum() - expected[i]) <= 1.0 + 1e-9


@pytest.mark.unit
def test_comb_uniform_weights_is_identity_multiset():
    state = make_state([1.0, 1.0, 1.0, 1.0])
    out = pc.comb(state, jax.random.key(7), target_weight=4.0)
    assert sorted(walker_tag(out)) == [0, 1, 2, 3]


@pytest.mark.unit
def test_pair_branch_pairs_extremes():
    w = [0.01, 1.0, 1.0, 5.0]
    state = make_state(w)
    out = pc.pair_branch(state, jax.random.key(2), target_weight=4.0)
    wts = np.asarray(out.weight)
    tags = walker_tag(out)
    total = sum(w) * (4.0 / sum(w))
    # Weight is conserved by pairing.
    assert wts.sum() == pytest.approx(total)
    # The tiny walker was paired with the big one: both slots carry half the
    # scaled pair weight and the same parent.
    scaled = np.array(w) * 4.0 / sum(w)
    pair = 0.5 * (scaled[0] + scaled[3])
    assert wts[0] == pytest.approx(pair)
    assert wts[3] == pytest.approx(pair)
    assert tags[0] == tags[3]
    # Middle walkers untouched.
    assert tags[1] == 1 and tags[2] == 2


@pytest.mark.unit
def test_pair_branch_no_op_when_balanced():
    state = make_state([1.0, 1.1, 0.9, 1.0])
    out = pc.pair_branch(state, jax.random.key(3), target_weight=4.0)
    assert sorted(walker_tag(out)) == [0, 1, 2, 3]


@pytest.mark.unit
def test_pop_control_dead_population_stays_dead():
    """An all-dead population (every weight 0) must come out of BOTH
    algorithms with zero weights and no NaNs — the reference ABORTS on
    vanishing total weight (handler.py:236-241); in-jit the honest
    equivalent is preserving the dead state (comb previously resurrected
    everyone at weight 1; pair_branch produced NaN)."""
    import jax
    import jax.numpy as jnp

    from pauxy_jax.models import make_hubbard, free_electron_trial
    from pauxy_jax.walkers import init_walkers
    from pauxy_jax.walkers import pop_control as pc

    ham = make_hubbard(nup=2, ndown=2, U=4.0, nx=2, ny=2)
    state = init_walkers(free_electron_trial(ham), 8)
    dead = state.replace(weight=jnp.zeros(8))
    for method in ("comb", "pair_branch"):
        out = pc.pop_control(dead, jax.random.key(0), 8.0, method)
        w = np.asarray(out.weight)
        assert np.isfinite(w).all(), method
        np.testing.assert_allclose(w, 0.0, err_msg=method)


@pytest.mark.driver
def test_driver_aborts_on_dead_population(tmp_path):
    """The driver raises when the whole population dies (the reference
    sys.exits, handler.py:236-241) instead of streaming NaN/zero rows."""
    import jax.numpy as jnp

    from pauxy_jax.models import make_hubbard, free_electron_trial
    from pauxy_jax.qmc import AFQMC, QMCOpts

    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    trial = free_electron_trial(ham)
    qmc = QMCOpts(nwalkers=4, dt=0.01, nsteps=2, nblocks=2, rng_seed=1)
    af = AFQMC(ham, trial, qmc, filename=str(tmp_path / "dead.h5"))
    af.state = af.state.replace(weight=jnp.zeros(4))
    with pytest.raises(RuntimeError, match="population died"):
        af.run()

    from pauxy_jax.models.thermal_trial import make_one_body_trial
    from pauxy_jax.qmc.thermal_afqmc import ThermalAFQMC

    ttrial = make_one_body_trial(ham, 0.25, 0.05)
    tqmc = QMCOpts(nwalkers=4, dt=0.05, nsteps=1, nblocks=1, beta=0.25,
                   rng_seed=1)
    taf = ThermalAFQMC(ham, ttrial, tqmc, filename=str(tmp_path / "tdead.h5"))
    taf.state = taf.state.replace(weight=jnp.zeros(4))
    with pytest.raises(RuntimeError, match="population died"):
        taf.run()
