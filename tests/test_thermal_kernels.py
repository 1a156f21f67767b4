"""Finite-T kernel tests: pivoted QR, stratified products, 1-RDMs."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

from pauxy_jax.estimators import thermal
from pauxy_jax.ops import cpqr


def rand_c(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.unit
def test_cpqr_reconstruction():
    rng = np.random.default_rng(0)
    a = rand_c(rng, 3, 6, 6)
    # Badly scaled columns to exercise the pivoting.
    a[..., :, 0] *= 1e6
    a[..., :, 3] *= 1e-6
    q, r, perm = cpqr.cpqr(jnp.asarray(a))
    q, r, perm = np.asarray(q), np.asarray(r), np.asarray(perm)
    for b in range(3):
        np.testing.assert_allclose(a[b][:, perm[b]], q[b] @ r[b], atol=1e-8)
        np.testing.assert_allclose(
            q[b].conj().T @ q[b], np.eye(6), atol=1e-10
        )
        # R diagonal magnitudes are non-increasing (pivoting worked).
        dm = np.abs(np.diagonal(r[b]))
        assert np.all(dm[:-1] >= dm[1:] - 1e-8)
        # upper triangular
        assert np.abs(np.tril(r[b], -1)).max() < 1e-6


@pytest.mark.unit
def test_cpqr_real():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((2, 5, 5))
    q, r, perm = cpqr.cpqr(jnp.asarray(a))
    for b in range(2):
        np.testing.assert_allclose(
            a[b][:, np.asarray(perm)[b]], np.asarray(q)[b] @ np.asarray(r)[b],
            atol=1e-10,
        )


@pytest.mark.unit
def test_greens_qdt_vs_direct():
    """(1 + prod B)^-1 matches a direct inverse for a well-conditioned case
    and stays accurate for an ill-conditioned long product."""
    rng = np.random.default_rng(2)
    m, nbins = 6, 4
    h = rng.standard_normal((m, m))
    h = 0.5 * (h + h.T)
    b_one = scipy.linalg.expm(-0.3 * h)
    stack = np.broadcast_to(b_one, (2, nbins, m, m)).copy()
    g = np.asarray(thermal.greens_function_qdt(jnp.asarray(stack + 0j)))
    a = np.linalg.matrix_power(b_one, nbins)
    g_ref = np.linalg.inv(np.eye(m) + a)
    np.testing.assert_allclose(g[0], g_ref, atol=1e-9)
    np.testing.assert_allclose(g[1], g_ref, atol=1e-9)

    # Long product: direct inverse would lose all digits; compare against
    # the eigenbasis exact result. beta*W ~ 0.3*16*spread.
    nbins2 = 16
    stack2 = np.broadcast_to(b_one, (1, nbins2, m, m)).copy()
    g2 = np.asarray(thermal.greens_function_qdt(jnp.asarray(stack2 + 0j)))[0]
    evals, evecs = np.linalg.eigh(h)
    gd = 1.0 / (1.0 + np.exp(-0.3 * nbins2 * evals))
    g_exact = evecs @ np.diag(gd) @ evecs.T
    np.testing.assert_allclose(g2, g_exact, atol=1e-8)


@pytest.mark.unit
def test_one_rdm_stable_host_vs_fermi():
    """Host stratified 1-RDM of exp(-dtau(H-mu)) over n slices equals the
    Fermi function in the eigenbasis."""
    rng = np.random.default_rng(3)
    m = 8
    h = rng.standard_normal((m, m))
    h = 0.5 * (h + h.T)
    dtau, n, mu = 0.5, 20, 0.3
    bt = scipy.linalg.expm(-dtau * (h - mu * np.eye(m)))
    p = thermal.one_rdm_stable_host(np.array([bt, bt]), n)
    evals, evecs = np.linalg.eigh(h)
    occ = thermal.fermi_factor(evals, dtau * n, mu)
    p_exact = (evecs * occ[None, :]) @ evecs.T
    # P = 1 - G^T with G = (1+A)^-1; for symmetric A this is the Fermi 1-RDM.
    np.testing.assert_allclose(p[0].real, p_exact, atol=1e-8)
    assert abs(thermal.particle_number_host(p) - 2 * occ.sum()) < 1e-8


@pytest.mark.unit
def test_device_matches_host_stratification():
    rng = np.random.default_rng(4)
    m, nbins = 5, 12
    h = rng.standard_normal((m, m))
    h = 0.5 * (h + h.T)
    bt = scipy.linalg.expm(-0.4 * h)
    stack = np.broadcast_to(bt, (nbins, m, m)) + 0j
    g_dev = np.asarray(thermal.greens_function_qdt(jnp.asarray(stack[None])))[0]
    p_host = thermal.one_rdm_stable_host(np.array([bt, bt]), nbins)
    g_host = np.eye(m) - p_host[0].T
    np.testing.assert_allclose(g_dev, g_host, atol=1e-9)


@pytest.mark.unit
def test_entropy_vs_reference():
    """Mean-field entropy vs pauxy.estimators.thermal.entropy."""
    import os, sys
    if not os.path.isdir("/root/reference/pauxy"):
        pytest.skip("no reference")
    sys.path.insert(0, "/root/reference")
    from pauxy.estimators.thermal import entropy as ref_entropy

    from pauxy_jax.estimators.thermal import entropy
    from pauxy_jax.models import make_hubbard

    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    h1 = np.asarray(ham.T)
    for beta, mu in [(0.5, 0.1), (1.0, 0.0), (2.0, -0.5)]:
        assert entropy(beta, mu, h1) == pytest.approx(
            ref_entropy(beta, mu, h1), rel=1e-10
        )


@pytest.mark.driver
def test_thermal_ehyb_ovlp_one_rdm(tmp_path):
    """EHybrid/Overlap columns are live and the thermal 1-RDM output is
    normalized: tr P = Nav per block."""
    import os, sys

    from pauxy_jax.models import make_hubbard
    from pauxy_jax.models.thermal_trial import make_one_body_trial
    from pauxy_jax.qmc import QMCOpts
    from pauxy_jax.qmc.thermal_afqmc import ThermalAFQMC

    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    beta, dt = 0.5, 0.05
    trial = make_one_body_trial(ham, beta, dt)
    qmc = QMCOpts(nwalkers=8, dt=dt, nsteps=1, nblocks=3, beta=beta,
                  npop_control=5, rng_seed=3)
    fn = str(tmp_path / "t.h5")
    af = ThermalAFQMC(ham, trial, qmc,
                      estimator_options={"mixed": {"one_rdm": True}},
                      filename=fn)
    rows = af.run()
    # Overlap column = 1 (thermal ot = 1, mixed.py:224); EHybrid is finite
    # and nonzero after the first block (tracked per-slice hybrid energy).
    np.testing.assert_allclose(rows[:, 9].real, 1.0, atol=1e-6)
    assert np.isfinite(rows[:, 8].real).all()
    assert abs(rows[-1, 8].real) > 1e-8

    if not os.path.isdir("/root/reference/pauxy"):
        return
    sys.path.insert(0, "/root/reference")
    from pauxy.analysis.extraction import extract_data

    rdms = extract_data(fn, "basic", "one_rdm", raw=True)
    assert rdms.shape[1:] == (2, ham.nbasis, ham.nbasis)
    traces = np.einsum("bsii->b", rdms).real
    np.testing.assert_allclose(traces, rows[:, 10].real, atol=1e-5)


@pytest.mark.driver
def test_thermal_average_gf(tmp_path):
    """tau-averaged measurement (mixed.py:182-199 average_gf): at U=0 both
    estimators must equal the exact grand-canonical values; with
    interactions the cyclic average must agree with the end-of-path value
    within statistics."""
    from pauxy_jax.models import make_hubbard
    from pauxy_jax.models.thermal_trial import make_one_body_trial
    from pauxy_jax.qmc import QMCOpts
    from pauxy_jax.qmc.thermal_afqmc import ThermalAFQMC

    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    beta, dt = 0.5, 0.05
    trial = make_one_body_trial(ham, beta, dt)
    qmc = QMCOpts(nwalkers=24, dt=dt, nsteps=1, nblocks=6, beta=beta,
                  npop_control=5, rng_seed=3)
    rows = {}
    for avg in (False, True):
        af = ThermalAFQMC(
            ham, trial, qmc,
            estimator_options={"mixed": {"average_gf": avg}},
            filename=str(tmp_path / f"avg{int(avg)}.h5"))
        rows[avg] = af.run()
    et0 = rows[False][1:, 5].real
    et1 = rows[True][1:, 5].real
    assert np.isfinite(et1).all()
    # Same physics, better statistics: means agree within a loose window.
    assert abs(et0.mean() - et1.mean()) < 0.5, (et0.mean(), et1.mean())
    # Nav agrees too.
    assert abs(rows[True][1:, 10].real.mean()
               - rows[False][1:, 10].real.mean()) < 0.2


def _numpy_cpqr_swaps(a):
    """Textbook column-pivoted Householder QR of one square matrix in
    numpy: physical column swaps and a per-step rank-1 Q update, with the
    same reflector convention (alpha = -phase(x0) |x|) as ops/cpqr."""
    a = np.array(a, dtype=complex)
    m = a.shape[-1]
    r, q, perm = a.copy(), np.eye(m, dtype=complex), np.arange(m)
    for k in range(m):
        p = k + int(np.argmax(np.sum(np.abs(r[k:, k:]) ** 2, axis=0)))
        r[:, [k, p]] = r[:, [p, k]]
        perm[[k, p]] = perm[[p, k]]
        x = np.zeros(m, complex)
        x[k:] = r[k:, k]
        x0 = x[k]
        phase = x0 / abs(x0) if abs(x0) > 0 else 1.0
        v = x.copy()
        v[k] += phase * np.linalg.norm(x)
        vsq = np.vdot(v, v).real
        if vsq <= 1e-300:
            continue
        r -= np.outer(v, v.conj() @ r) * (2.0 / vsq)
        q -= np.outer(q @ v, v.conj()) * (2.0 / vsq)
    return q, np.triu(r), perm


@pytest.mark.unit
def test_cpqr_deferred_pivot_matches_swaps():
    """The WY/deferred-pivot default (_cpqr_xla) applies the exact same
    reflection sequence as the textbook swaps loop (a numpy float64
    reference): identical pivot order, bit-level-close R, and Q equal to
    working precision."""
    rng = np.random.default_rng(11)
    a = rand_c(rng, 4, 33, 33)
    a[1] *= np.logspace(0, -8, 33)[None, :]               # ill-conditioned
    ad = jnp.asarray(a)
    q1, r1, p1 = map(np.asarray, cpqr._cpqr_xla(ad))
    q2, r2, p2 = (np.stack(x) for x in zip(*map(_numpy_cpqr_swaps, a)))
    assert (p1 == p2).all()
    np.testing.assert_allclose(r1, r2, atol=1e-10)
    np.testing.assert_allclose(q1, q2, atol=1e-8)
    # And the identities hold independently.
    for b in range(4):
        np.testing.assert_allclose(a[b][:, p1[b]], q1[b] @ r1[b], atol=1e-7)
        np.testing.assert_allclose(
            q1[b].conj().T @ q1[b], np.eye(33), atol=1e-9
        )


@pytest.mark.unit
def test_cpqr_nopivot():
    rng = np.random.default_rng(12)
    a = rand_c(rng, 2, 9, 9)
    q, r, perm = cpqr.cpqr(jnp.asarray(a), pivot=False)
    q, r, perm = np.asarray(q), np.asarray(r), np.asarray(perm)
    assert (perm == np.arange(9)).all()
    for b in range(2):
        np.testing.assert_allclose(a[b], q[b] @ r[b], atol=1e-9)
        assert np.abs(np.tril(r[b], -1)).max() < 1e-9


@pytest.mark.unit
def test_unpermute_columns_onehot():
    rng = np.random.default_rng(13)
    t = rand_c(rng, 3, 7, 7)
    perm = np.stack([rng.permutation(7) for _ in range(3)])
    out = np.asarray(
        cpqr.unpermute_columns(jnp.asarray(t), jnp.asarray(perm))
    )
    for b in range(3):
        want = np.empty_like(t[b])
        want[:, perm[b]] = t[b]
        np.testing.assert_allclose(out[b], want, atol=1e-12)


@pytest.mark.unit
def test_prefix_cached_propagation_matches_full_refold():
    """The prefix-cached per-slice Green's function (walker pq/pd/pt carry)
    is bit-identical to the legacy full re-stratification over all bins."""
    import jax

    from pauxy_jax.models import make_hubbard
    from pauxy_jax.models.thermal_trial import make_one_body_trial
    from pauxy_jax.propagation.thermal import make_thermal_propagator
    from pauxy_jax.walkers import thermal_state as tws

    ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
    beta, dt = 1.0, 0.05
    trial = make_one_body_trial(ham, beta, dt, mu=1.0, stack_size=5)
    assert trial.nbins == 4
    prop = make_thermal_propagator(ham, trial, dt)

    state = tws.init_thermal_walkers(trial, 4)
    legacy = state.replace(pq=None, pd=None, pt=None)
    key = jax.random.PRNGKey(3)
    for ts in range(int(round(beta / dt))):
        key, k = jax.random.split(key)
        state = prop.propagate(trial, state, k, ts)
        legacy = prop.propagate(trial, legacy, k, ts)
    np.testing.assert_allclose(
        np.asarray(state.G), np.asarray(legacy.G), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(state.log_m0), np.asarray(legacy.log_m0), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(state.weight), np.asarray(legacy.weight), atol=1e-12
    )
