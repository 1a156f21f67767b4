"""Generic (Cholesky ab-initio) system: kernels vs the reference's numpy
implementations on identical random Hamiltonians.

Mirrors ``pauxy/estimators/tests/test_generic.py`` and
``pauxy/propagation/tests/test_generic.py`` style.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from pauxy_jax.estimators import local_energy as le
from pauxy_jax.models import make_generic, rhf_identity_trial
from pauxy_jax.models.trial import trial_from_orbitals
from pauxy_jax.ops import greens
from pauxy_jax.propagation import generic as gprop
from pauxy_jax.utils.testing import generate_hamiltonian, random_wavefunction

REFERENCE = "/root/reference"
HAVE_REF = os.path.isdir(os.path.join(REFERENCE, "pauxy"))
if HAVE_REF:
    sys.path.insert(0, REFERENCE)


def build(nmo=7, nelec=(3, 2), seed=7):
    h1e, chol, enuc, eri = generate_hamiltonian(nmo, nelec, seed=seed)
    ham = make_generic(nelec, h1e, chol, enuc)
    psi = random_wavefunction(nmo, nelec, seed=seed + 1)
    trial = trial_from_orbitals(ham, psi)
    return ham, trial, (h1e, chol, enuc, eri)


@pytest.mark.unit
def test_h1e_mod_vs_reference():
    if not HAVE_REF:
        pytest.skip("no reference")
    from pauxy.systems.generic import construct_h1e_mod as ref_mod

    nmo = 6
    h1e, chol, enuc, _ = generate_hamiltonian(nmo, (2, 2), seed=3)
    ham = make_generic((2, 2), h1e, chol, enuc)
    out = np.zeros((2, nmo, nmo))
    ref_mod(chol.reshape(nmo * nmo, -1), np.stack([h1e, h1e]), out)
    np.testing.assert_allclose(np.asarray(ham.h1e_mod), out, atol=1e-12)


@pytest.mark.unit
def test_local_energy_opt_vs_dense_and_reference():
    ham, trial, (h1e, chol, enuc, eri) = build()
    nw = 3
    rng = np.random.default_rng(5)
    phi = rng.standard_normal((nw, ham.nbasis, ham.nup + ham.ndown)) + 1j * (
        rng.standard_normal((nw, ham.nbasis, ham.nup + ham.ndown))
    )
    ga = greens.greens_function(jnp.asarray(phi[:, :, : ham.nup]), trial.psia)
    gb = greens.greens_function(jnp.asarray(phi[:, :, ham.nup :]), trial.psib)
    etot, e1b, e2b = le.local_energy_generic_opt(trial, ga.Ghalf, gb.Ghalf, ham.ecore)

    for w in range(nw):
        g = np.stack([np.asarray(ga.G[w]), np.asarray(gb.G[w])])
        # dense in-package host kernel
        eh, e1h, e2h = le.local_energy_G_host(ham, g)
        np.testing.assert_allclose(complex(etot[w]), eh, rtol=1e-8)
        if HAVE_REF:
            from pauxy.estimators.generic import (
                local_energy_generic,
                local_energy_generic_cholesky_opt,
            )

            ref = local_energy_generic(np.stack([h1e, h1e]), eri, g, ecore=enuc)
            np.testing.assert_allclose(complex(etot[w]), ref[0], rtol=1e-8)
            np.testing.assert_allclose(complex(e1b[w]), ref[1], rtol=1e-8)
            np.testing.assert_allclose(complex(e2b[w]), ref[2], rtol=1e-8)

            # reference half-rotated fast kernel on the same walker
            class S:
                pass

            s = S()
            s.nup, s.ndown, s.nbasis, s.ecore = ham.nup, ham.ndown, ham.nbasis, enuc
            s.H1 = np.stack([h1e, h1e])
            m, na, nb = ham.nbasis, ham.nup, ham.ndown
            psi = np.asarray(
                np.concatenate([np.asarray(trial.psia), np.asarray(trial.psib)], axis=1)
            )
            cholf = chol.reshape(m * m, -1)
            rup = np.tensordot(
                psi[:, :na].conj(), chol, axes=((0), (0))
            ).reshape(na * m, -1)
            rdn = np.tensordot(
                psi[:, na:].conj(), chol, axes=((0), (0))
            ).reshape(nb * m, -1)
            rchol = np.concatenate([rup, rdn], axis=0)
            ghalf = [np.asarray(ga.Ghalf[w]), np.asarray(gb.Ghalf[w])]
            ref2 = local_energy_generic_cholesky_opt(s, g, ghalf, rchol)
            np.testing.assert_allclose(complex(etot[w]), ref2[0], rtol=1e-8)


@pytest.mark.unit
def test_propagator_setup_vs_reference():
    if not HAVE_REF:
        pytest.skip("no reference")
    ham, trial, (h1e, chol, enuc, eri) = build(nmo=6, nelec=(2, 2), seed=11)

    class Sys:
        pass

    s = Sys()
    s.nup, s.ndown, s.nbasis, s.ecore = 2, 2, 6, enuc
    s.H1 = np.stack([h1e, h1e])
    s.nfields = ham.nchol
    s.chol_vecs = chol.reshape(36, -1)
    s.hs_pot = s.chol_vecs
    s.sparse = False
    s.h1e_mod = np.asarray(ham.h1e_mod)

    class Tr:
        pass

    t = Tr()
    t.G = np.asarray(trial.G_host.arr)
    t.ndets = 1

    class Qmc:
        dt = 0.01
        nstblz = 5

    from pauxy.propagation.generic import GenericContinuous as RefProp

    ref = RefProp(s, t, Qmc())
    mine = gprop.make_generic_continuous(ham, trial, 0.01)
    np.testing.assert_allclose(np.asarray(mine.mf_shift), ref.mf_shift, atol=1e-10)
    np.testing.assert_allclose(np.asarray(mine.BH1), ref.BH1, atol=1e-10)

    # force bias on a random walker
    nw = 2
    phi = random_wavefunction(6, (2, 2), seed=4)
    phiw = np.broadcast_to(phi, (nw,) + phi.shape)
    ga = greens.greens_function(jnp.asarray(phiw[:, :, :2]), trial.psia)
    gb = greens.greens_function(jnp.asarray(phiw[:, :, 2:]), trial.psib)
    fb = np.asarray(mine.force_bias(trial, ga, gb))

    class W:
        pass

    w = W()
    w.G = np.stack([np.asarray(ga.G[0]), np.asarray(gb.G[0])])
    ref_fb_slow = ref.construct_force_bias_slow(s, w, t)
    np.testing.assert_allclose(fb[0], ref_fb_slow, atol=1e-10)

    # VHS application matches reference Taylor on one walker
    x = np.random.default_rng(0).standard_normal(ham.nchol)
    vhs_ref = ref.construct_VHS_fast(s, x)
    pa, pb = mine.apply_vhs(
        jnp.asarray(phiw[:, :, :2].astype(complex)),
        jnp.asarray(phiw[:, :, 2:].astype(complex)),
        jnp.asarray(np.broadcast_to(x, (nw, ham.nchol)).astype(complex)),
    )
    import scipy.linalg

    expref = scipy.linalg.expm(vhs_ref) @ phi[:, :2]
    np.testing.assert_allclose(np.asarray(pa[0]), expref, atol=1e-6)


@pytest.mark.driver
def test_generic_afqmc_runs(tmp_path):
    from pauxy_jax.qmc import AFQMC, QMCOpts

    h1e, chol, enuc, _ = generate_hamiltonian(6, (2, 2), seed=21)
    ham = make_generic((2, 2), h1e, chol, enuc)
    trial = rhf_identity_trial(ham)
    qmc = QMCOpts(nwalkers=10, dt=0.005, nsteps=10, nblocks=5, nstblz=5,
                  npop_control=5, rng_seed=8)
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": 1}},
               filename=str(tmp_path / "g.h5"))
    rows = af.run()
    assert np.isfinite(rows.real).all()
    # Variational bound-ish: projected energy should not wander far above the
    # trial energy on a stable short run.
    assert rows[-1, 5].real < trial.etrial + 1.0


@pytest.mark.unit
def test_generic_energy_variants():
    """exact-ERI / PNO / stochastic-RI local-energy variants vs the exact
    Cholesky fast path (``pauxy/estimators/generic.py:34,130,293``)."""
    import jax

    from pauxy_jax.models.generic import make_generic
    from pauxy_jax.models.trial import rhf_identity_trial
    from pauxy_jax.ops import greens as gops

    rng = np.random.default_rng(7)
    nmo, na = 8, 3
    chol = rng.normal(scale=0.1, size=(nmo, nmo, 17))
    chol = 0.5 * (chol + chol.transpose(1, 0, 2))
    h1 = rng.normal(scale=0.2, size=(nmo, nmo))
    h1 = 0.5 * (h1 + h1.T)

    def build(**flags):
        ham = make_generic((na, na), np.stack([h1, h1]), chol, ecore=0.3,
                           **flags)
        return ham, rhf_identity_trial(ham)

    ham0, trial0 = build()
    nw = 4
    phi = rng.standard_normal((nw, nmo, 2 * na)) + 1j * rng.standard_normal(
        (nw, nmo, 2 * na)
    )
    ga = gops.greens_function(jnp.asarray(phi[:, :, :na]), trial0.psia)
    gb = gops.greens_function(jnp.asarray(phi[:, :, na:]), trial0.psib)
    exact = np.asarray(le.local_energy_generic_opt(
        trial0, ga.Ghalf, gb.Ghalf, ham0.ecore)[0])

    # exact_eri must agree to roundoff.
    ham1, trial1 = build(exact_eri=True)
    e_eri = np.asarray(le.local_energy_generic_exact_eri(
        trial1, ga.Ghalf, gb.Ghalf, ham1.ecore)[0])
    np.testing.assert_allclose(e_eri, exact, rtol=1e-9)

    # PNO with a negligible threshold keeps every singular direction.
    ham2, trial2 = build(pno=True, thresh_pno=1e-13)
    e_pno = np.asarray(le.local_energy_generic_pno(
        trial2, ga.Ghalf, gb.Ghalf, ham2.ecore)[0])
    np.testing.assert_allclose(e_pno, exact, rtol=1e-8)

    # Stochastic RI with the control variate is EXACT at phi = trial
    # (correction term cancels sample-by-sample) ...
    ham3, trial3 = build(stochastic_ri=True, nsamples=10,
                         control_variate=True)
    phi0a = jnp.broadcast_to(trial3.psia[None], (1,) + trial3.psia.shape)
    phi0b = jnp.broadcast_to(trial3.psib[None], (1,) + trial3.psib.shape)
    g0a = gops.greens_function(phi0a, trial3.psia)
    g0b = gops.greens_function(phi0b, trial3.psib)
    e_exact0 = np.asarray(le.local_energy_generic_opt(
        trial3, g0a.Ghalf, g0b.Ghalf, ham3.ecore)[0])
    e_sri0 = np.asarray(le.local_energy_generic_stochastic_ri(
        trial3, g0a.Ghalf, g0b.Ghalf, ham3.ecore, jax.random.key(3),
        10, True)[0])
    np.testing.assert_allclose(e_sri0, e_exact0, rtol=1e-6)

    # ... and an unbiased estimator elsewhere: averaging over many probe
    # sets converges to the exact energy, with the control variate tighter.
    est_cv, est_raw = [], []
    for k in range(60):
        key = jax.random.key(100 + k)
        est_cv.append(np.asarray(le.local_energy_generic_stochastic_ri(
            trial3, ga.Ghalf, gb.Ghalf, ham3.ecore, key, 24, True)[0]))
        est_raw.append(np.asarray(le.local_energy_generic_stochastic_ri(
            trial3, ga.Ghalf, gb.Ghalf, ham3.ecore, key, 24, False)[0]))
    mean_cv = np.mean(est_cv, axis=0)
    mean_raw = np.mean(est_raw, axis=0)
    scale = np.abs(exact).max()
    assert np.abs(mean_cv - exact).max() < 0.05 * scale
    assert np.abs(mean_raw - exact).max() < 0.2 * scale


@pytest.mark.driver
def test_generic_stochastic_ri_driver(tmp_path):
    """Driver smoke: stochastic-RI energy path inside the fused block."""
    from pauxy_jax.models.generic import make_generic
    from pauxy_jax.models.trial import rhf_identity_trial
    from pauxy_jax.qmc import AFQMC, QMCOpts

    rng = np.random.default_rng(11)
    nmo, na = 8, 3
    chol = rng.normal(scale=0.05, size=(nmo, nmo, 17))
    chol = 0.5 * (chol + chol.transpose(1, 0, 2))
    h1 = rng.normal(scale=0.1, size=(nmo, nmo))
    h1 = 0.5 * (h1 + h1.T)
    ham = make_generic((na, na), np.stack([h1, h1]), chol, ecore=0.0,
                       stochastic_ri=True, nsamples=16, control_variate=True)
    trial = rhf_identity_trial(ham)
    qmc = QMCOpts(nwalkers=10, dt=0.01, nsteps=5, nblocks=3, nstblz=5,
                  npop_control=5, rng_seed=8)
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": 1}},
               filename=str(tmp_path / "sri.h5"))
    rows = af.run()
    assert np.isfinite(rows.real).all()


@pytest.mark.unit
def test_freeze_core_preserves_ground_state():
    """Folding doubly-occupied core orbitals into h1/ecore must preserve the
    FCI ground-state energy when the core is energetically decoupled
    (block-diagonal Hamiltonian), and the frozen-core energy must equal the
    core determinant's energy (``pauxy/utils/from_pyscf.py:195-220``)."""
    from pauxy_jax.estimators import ci
    from pauxy_jax.models.generic import make_generic
    from pauxy_jax.utils.from_pyscf import freeze_core

    rng = np.random.default_rng(9)
    nc, ncas = 1, 3
    m = nc + ncas
    # Block-diagonal: core orbital decoupled from the active space so
    # freezing is exact.
    h1 = np.zeros((m, m))
    h1[0, 0] = -5.0
    h1a = rng.normal(scale=0.4, size=(ncas, ncas))
    h1[nc:, nc:] = 0.5 * (h1a + h1a.T)
    chol = np.zeros((m, m, 6))
    ca = rng.normal(scale=0.2, size=(ncas, ncas, 5))
    ca = 0.5 * (ca + ca.transpose(1, 0, 2))
    chol[nc:, nc:, :5] = ca
    chol[0, 0, 5] = 0.3   # core-core repulsion only

    # Full-space FCI with (1+na, 1+nb) electrons (core doubly occupied in
    # the ground state because of the deep core level).
    na_act = 1
    full = make_generic((nc + na_act, nc + na_act), np.stack([h1, h1]),
                        chol, ecore=0.7)
    e_full, _, _ = ci.simple_fci(full)

    h1_act, chol_act, ecore_f = freeze_core(h1, chol, 0.7, nc, ncas)
    act = make_generic((na_act, na_act), h1_act, chol_act, ecore=ecore_f)
    e_act, _, _ = ci.simple_fci(act)
    assert float(e_act[0]) == pytest.approx(float(e_full[0]), abs=1e-10)


def _taylor_numpy(vhs, phi, order=6):
    """Truncated Taylor series exp(VHS) phi in float64 numpy."""
    temp = acc = phi.astype(complex)
    for k in range(1, order + 1):
        temp = np.einsum("wpq,wqn->wpn", vhs, temp) / k
        acc = acc + temp
    return acc


@pytest.mark.unit
@pytest.mark.parametrize("impl", ["xla", "xla_3m"])
@pytest.mark.parametrize("w,m,n", [(6, 20, 7), (3, 33, 16)])
def test_taylor_matches_numpy(impl, w, m, n):
    """Both Taylor expm-apply variants (complex einsum, 3M Karatsuba split)
    equal the float64 truncated series."""
    import jax.numpy as jnp

    from pauxy_jax.propagation.generic import (
        apply_exponential_taylor, apply_exponential_taylor_3m)

    rng = np.random.default_rng(0)
    vhs = 0.1 * (rng.normal(size=(w, m, m)) + 1j * rng.normal(size=(w, m, m)))
    phi = rng.normal(size=(w, m, n)) + 1j * rng.normal(size=(w, m, n))
    fn = apply_exponential_taylor_3m if impl == "xla_3m" else \
        apply_exponential_taylor
    out = np.asarray(fn(jnp.asarray(vhs), jnp.asarray(phi)))
    ref = _taylor_numpy(vhs, phi)
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-12


@pytest.mark.unit
@pytest.mark.parametrize("max_elems", [1 << 27, 5 * 24 * 16, 5 * 24 * 7])
def test_exx_chunked_matches_einsum(max_elems):
    """The exchange energy without a supermatrix: one einsum when the
    [w, X, n, n] intermediate fits, else the Cholesky-axis chunked scan
    (chunks that do and do not divide X, odd walker counts)."""
    import jax.numpy as jnp

    from pauxy_jax.estimators.local_energy import _exx

    rng = np.random.default_rng(1)
    X, n, m, w = 37, 5, 24, 11
    rc = rng.normal(size=(X, n, m))
    gh = rng.normal(size=(w, n, m)) + 1j * rng.normal(size=(w, n, m))
    t = np.einsum("xim,wjm->wxij", rc, gh)
    ref = np.einsum("wxij,wxji->w", t, t)
    out = np.asarray(_exx(jnp.asarray(rc), jnp.asarray(gh),
                          max_elems=max_elems))
    np.testing.assert_allclose(out, ref, rtol=1e-11)


@pytest.mark.driver
def test_generic_driver_taylor_3m_trajectory(tmp_path):
    """A Generic run with taylor_impl='xla_3m' is trajectory-equal to the
    default complex-einsum path (same RNG stream)."""
    from pauxy_jax.qmc import AFQMC, QMCOpts

    def run(impl, fname):
        h1e, chol, enuc, _ = generate_hamiltonian(6, (2, 2), seed=21)
        ham = make_generic((2, 2), h1e, chol, enuc)
        trial = rhf_identity_trial(ham)
        qmc = QMCOpts(nwalkers=6, dt=0.01, nsteps=4, nblocks=2, nstblz=5,
                      npop_control=5, rng_seed=5)
        af = AFQMC(ham, trial, qmc,
                   propagator_options={"taylor_impl": impl},
                   estimator_options={"mixed": {"energy_eval_freq": 1}},
                   filename=str(tmp_path / fname))
        return af.run()

    r_x = run("xla", "tx.h5")
    r_3 = run("xla_3m", "t3.h5")
    # Drop the trailing wall-clock Time column (never reproducible).
    np.testing.assert_allclose(np.asarray(r_x).real[:, :-1],
                               np.asarray(r_3).real[:, :-1],
                               rtol=1e-8, atol=1e-10)


@pytest.mark.unit
def test_hartree_fock_excitation_promotion_energy():
    """trial.excitation=[i, a]: MO-basis HF determinant with occupied alpha
    orbital i promoted to virtual a (reference hartree_fock.py:57-77). The
    trial variational energy must match the reference HartreeFock class on
    the identical Hamiltonian."""
    from pauxy_jax.qmc.calc import get_trial_wavefunction
    from pauxy_jax.utils.transfer import to_host

    nmo, nelec = 6, (2, 2)
    h1e, chol, enuc, eri = generate_hamiltonian(nmo, nelec, seed=11)
    ham = make_generic(nelec, h1e, chol, enuc)
    trial = get_trial_wavefunction(
        ham, {"name": "hartree_fock", "excitation": [1, 3]})
    psia = np.asarray(to_host(trial.psia))
    # Column 1 is promoted to MO 3; column 0 stays MO 0.
    assert abs(psia[3, 1]) == pytest.approx(1.0)
    assert abs(psia[0, 0]) == pytest.approx(1.0)
    assert abs(psia[1, 1]) == pytest.approx(0.0)

    if not HAVE_REF:
        pytest.skip("no reference")
    from pauxy.estimators.greens_function import gab
    from pauxy.estimators.generic import local_energy_generic_cholesky

    class _Sys:
        pass

    sys_ = _Sys()
    sys_.nbasis, sys_.nup, sys_.ndown = nmo, 2, 2
    sys_.H1 = np.stack([h1e, h1e])
    sys_.chol_vecs = chol.reshape(nmo * nmo, -1)
    sys_.nchol = chol.shape[-1]
    sys_.ecore = enuc
    psi = np.zeros((nmo, 4), dtype=np.complex128)
    psi[0, 0] = psi[3, 1] = 1.0       # alpha: MO 0 occupied, MO1 -> MO3
    psi[0, 2] = psi[1, 3] = 1.0       # beta: MOs 0, 1
    g = np.array([gab(psi[:, :2], psi[:, :2]),
                  gab(psi[:, 2:], psi[:, 2:])])
    eref = local_energy_generic_cholesky(sys_, g)[0]
    assert float(trial.etrial) == pytest.approx(float(eref.real), abs=1e-8)

    with pytest.raises(NotImplementedError):
        get_trial_wavefunction(
            ham, {"name": "hartree_fock", "excitation": [1, 3],
                  "filename": "x.h5"})
