"""The plain XLA paths every backend runs, against numpy float64.

Covers the batched linear algebra at the widths of the benchmark
configurations, the absence of any Pallas call on the driver's hot paths,
the pytree dataclass helper, the driver without an output file or h5py,
and where the compile cache lives.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pauxy_jax.ops import clinalg, cpqr, greens

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand_c(rng, *shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _well_conditioned(rng, w, n):
    return _rand_c(rng, w, n, n) / np.sqrt(2 * n) + 2.0 * np.eye(n)


# ----------------------------------------------------------------------------
# batched linear algebra at the benchmark widths
# ----------------------------------------------------------------------------

@pytest.mark.unit
@pytest.mark.parametrize("n", [7, 16, 32, 64])
def test_solve_matches_numpy(n):
    rng = np.random.default_rng(n)
    s = _well_conditioned(rng, 6, n)
    y = _rand_c(rng, 6, n, 5)
    x = np.asarray(clinalg.solve(jnp.asarray(s), jnp.asarray(y)))
    np.testing.assert_allclose(x, np.linalg.solve(s, y), atol=1e-11)


@pytest.mark.unit
@pytest.mark.parametrize("n", [7, 16, 32, 64])
def test_slogdet_matches_numpy(n):
    rng = np.random.default_rng(100 + n)
    s = _rand_c(rng, 6, n, n)
    ld = np.asarray(clinalg.slogdet(jnp.asarray(s)))
    sign, logabs = np.linalg.slogdet(s)
    np.testing.assert_allclose(ld.real, logabs, atol=1e-10)
    np.testing.assert_allclose(np.exp(1j * ld.imag), sign, atol=1e-10)


@pytest.mark.unit
@pytest.mark.parametrize("n", [7, 16, 32, 64])
def test_inverse_matches_numpy(n):
    rng = np.random.default_rng(200 + n)
    s = _well_conditioned(rng, 4, n)
    inv = np.asarray(clinalg.inv(jnp.asarray(s)))
    np.testing.assert_allclose(inv, np.linalg.inv(s), atol=1e-11)


@pytest.mark.unit
@pytest.mark.parametrize("m,n", [(16, 7), (128, 16)])
def test_greens_function_matches_numpy(m, n):
    """G, Ghalf and log overlap at the Hubbard and Generic shapes."""
    rng = np.random.default_rng(m)
    psi = np.linalg.qr(_rand_c(rng, m, n))[0]
    phi = psi[None] + 0.3 * _rand_c(rng, 5, m, n) / np.sqrt(m)
    gf = greens.greens_function(jnp.asarray(phi), jnp.asarray(psi))
    smat = np.einsum("wmi,mj->wij", phi, psi.conj())
    ghalf = np.linalg.solve(smat, np.swapaxes(phi, -1, -2))
    np.testing.assert_allclose(np.asarray(gf.Ghalf), ghalf, atol=1e-11)
    np.testing.assert_allclose(
        np.asarray(gf.G), np.einsum("mi,win->wmn", psi.conj(), ghalf),
        atol=1e-11)
    sign, logabs = np.linalg.slogdet(smat)
    np.testing.assert_allclose(np.exp(np.asarray(gf.log_ovlp)),
                               sign * np.exp(logabs), rtol=1e-10)


@pytest.mark.unit
@pytest.mark.parametrize("n", [7, 16, 32])
def test_cholesky_qr2_matches_numpy(n):
    """Q spans the same columns with orthonormal columns, and log det R
    equals log |det R| of numpy's QR."""
    rng = np.random.default_rng(300 + n)
    phi = _rand_c(rng, 4, 3 * n, n)
    q, logr = clinalg.cholesky_qr2(jnp.asarray(phi))
    q, logr = np.asarray(q), np.asarray(logr)
    for b in range(4):
        np.testing.assert_allclose(q[b].conj().T @ q[b], np.eye(n),
                                   atol=1e-12)
        r = q[b].conj().T @ phi[b]
        np.testing.assert_allclose(q[b] @ r, phi[b], atol=1e-11)
        _, ld = np.linalg.slogdet(np.linalg.qr(phi[b])[1])
        assert logr[b] == pytest.approx(ld, abs=1e-10)


@pytest.mark.unit
@pytest.mark.parametrize("m", [16, 48, 93])
def test_cpqr_matches_scipy(m):
    """Column-pivoted QR: A P = Q R, Q unitary, and scipy's pivot order on
    matrices whose column norms are graded apart."""
    import scipy.linalg

    rng = np.random.default_rng(m)
    grade = 10.0 ** (-np.linspace(0, 3, m))[rng.permutation(m)]
    a = _rand_c(rng, 3, m, m) * grade[None, None, :]
    q, r, perm = (np.asarray(x) for x in cpqr.cpqr(jnp.asarray(a)))
    for b in range(3):
        np.testing.assert_allclose(a[b][:, perm[b]], q[b] @ r[b],
                                   atol=1e-11)
        np.testing.assert_allclose(q[b].conj().T @ q[b], np.eye(m),
                                   atol=1e-11)
        _, _, ref_perm = scipy.linalg.qr(a[b], pivoting=True)
        assert (perm[b] == ref_perm).all()


# ----------------------------------------------------------------------------
# no Pallas kernel on the driver's hot paths
# ----------------------------------------------------------------------------

def _block_jaxpr(family):
    """jaxpr of one compiled QMC block of ``family`` (tiny system)."""
    import functools

    from pauxy_jax.models import free_electron_trial, make_hubbard
    from pauxy_jax.models.generic import make_generic
    from pauxy_jax.models.trial import rhf_identity_trial
    from pauxy_jax.qmc import AFQMC, QMCOpts, afqmc, hubbard_fast
    from pauxy_jax.utils.testing import generate_hamiltonian

    popts = {}
    if family == "generic":
        h1e, chol, enuc, _ = generate_hamiltonian(6, (2, 2), seed=3)
        ham = make_generic((2, 2), h1e, chol, enuc)
        trial = rhf_identity_trial(ham)
    else:
        ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
        trial = free_electron_trial(ham)
        if family == "hubbard_discrete":
            popts = {"hubbard_stratonovich": "discrete"}
    qmc = QMCOpts(nwalkers=4, dt=0.01, nsteps=2, nblocks=1, nstblz=2,
                  npop_control=1, rng_seed=1)
    af = AFQMC(ham, trial, qmc, propagator_options=popts, filename=False)
    statics = dict(nsteps=2, nstblz=2, npop_control=1, pop_method="comb",
                   target_weight=4.0, energy_eval_freq=1)
    if af.use_fast_block:
        fn = functools.partial(hubbard_fast.run_block_lanes, **statics)
    else:
        fn = functools.partial(afqmc.run_block, free_projection=False,
                               **statics)
    args = (ham, trial, af.prop, af.state, jax.random.key(0),
            jnp.zeros((), af.state.log_ovlp.dtype), jnp.asarray(0))
    return af, str(jax.make_jaxpr(fn)(*args))


@pytest.mark.unit
@pytest.mark.parametrize("family", ["hubbard", "hubbard_discrete",
                                    "generic"])
def test_block_has_no_pallas_call(family):
    """Every backend runs the plain XLA program: no pallas_call (and so no
    interpret mode) inside a QMC block."""
    af, jaxpr = _block_jaxpr(family)
    assert af.use_fast_block == (family == "hubbard")
    assert "pallas_call" not in jaxpr


@pytest.mark.unit
def test_package_pallas_calls_name_their_backend():
    """No module imports a Pallas backend other than Triton, every
    pallas_call names its backend, and nothing hard-codes interpret mode."""
    allowed = {"from jax.experimental import pallas as pl",
               "from jax.experimental.pallas import triton as pltr"}
    pkg = os.path.join(ROOT, "pauxy_jax")
    calls = 0
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(dirpath, f)).read()
                for line in src.splitlines():
                    if "experimental" in line and "pallas" in line:
                        assert line.strip() in allowed, (f, line)
                assert "interpret=True" not in src, f
                n = src.count("pl.pallas_call(")
                assert src.count('backend="triton"') >= n, f
                calls += n
    assert calls == 1  # ops/sweep_triton.py


# ----------------------------------------------------------------------------
# pytree dataclass helper
# ----------------------------------------------------------------------------

def _point_class():
    from pauxy_jax.utils import pytree as struct

    @struct.dataclass
    class Point:
        x: jax.Array
        y: jax.Array = None
        scale: float = struct.field(pytree_node=False, default=1.0)

    return Point


@pytest.mark.unit
def test_pytree_replace_returns_new_frozen_instance():
    import dataclasses

    p = _point_class()(x=jnp.ones(3), y=jnp.zeros(2))
    q = p.replace(scale=2.0)
    assert q.scale == 2.0 and p.scale == 1.0
    assert q.x is p.x
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.scale = 3.0


@pytest.mark.unit
def test_pytree_static_fields_are_metadata():
    p = _point_class()(x=jnp.ones(3), y=jnp.zeros(2), scale=2.5)
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.scale == 2.5
    # A None data field is an empty subtree.
    assert len(jax.tree_util.tree_leaves(p.replace(y=None))) == 1


@pytest.mark.unit
def test_pytree_jit_cache_hits_on_equal_statics():
    traces = []

    @jax.jit
    def f(p):
        traces.append(1)
        return p.x * p.scale

    Point = _point_class()
    f(Point(x=jnp.ones(3)))
    f(Point(x=2 * jnp.ones(3)))             # same treedef: cache hit
    assert len(traces) == 1
    out = f(Point(x=jnp.ones(3), scale=3.0))  # new static: retrace
    assert len(traces) == 2
    np.testing.assert_allclose(np.asarray(out), 3.0)


@pytest.mark.unit
def test_pytree_tree_map_keeps_statics():
    p = _point_class()(x=jnp.ones(3), y=jnp.ones(2), scale=4.0)
    q = jax.tree_util.tree_map(lambda a: 2 * a, p)
    assert q.scale == 4.0
    np.testing.assert_allclose(np.asarray(q.y), 2.0)


# ----------------------------------------------------------------------------
# driver without an output file, and without h5py
# ----------------------------------------------------------------------------

def _no_h5py(monkeypatch):
    for name in ("h5py", "pandas", "flax"):
        monkeypatch.setitem(sys.modules, name, None)


@pytest.mark.unit
def test_import_without_optional_packages():
    """The drivers import in a fresh process without flax, h5py and
    pandas."""
    import subprocess

    code = ("import sys\n"
            "for m in ('h5py', 'pandas', 'flax'): sys.modules[m] = None\n"
            "import pauxy_jax.qmc, pauxy_jax.qmc.calc\n"
            "import pauxy_jax.qmc.thermal_afqmc\n"
            "print('ok')\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def _hubbard_driver(filename):
    from pauxy_jax.models import free_electron_trial, make_hubbard
    from pauxy_jax.qmc import AFQMC, QMCOpts

    ham = make_hubbard(nup=2, ndown=2, U=4.0, nx=2, ny=2)
    qmc = QMCOpts(nwalkers=4, dt=0.01, nsteps=2, nblocks=2, nstblz=2,
                  npop_control=1, rng_seed=1)
    return AFQMC(ham, free_electron_trial(ham), qmc, filename=filename)


@pytest.mark.unit
def test_driver_without_file_or_h5py(monkeypatch, tmp_path):
    _no_h5py(monkeypatch)
    monkeypatch.chdir(tmp_path)
    af = _hubbard_driver(False)
    rows = af.run()
    assert rows.shape[0] == 2 and np.isfinite(rows.real).all()
    assert af.filename is None and os.listdir(tmp_path) == []
    with pytest.raises(ValueError, match="filename=False"):
        af.get_energy()


@pytest.mark.unit
def test_driver_asking_for_h5_without_h5py_fails_clearly(monkeypatch,
                                                         tmp_path):
    _no_h5py(monkeypatch)
    with pytest.raises(ImportError, match="filename=False"):
        _hubbard_driver(str(tmp_path / "est.h5"))


@pytest.mark.unit
def test_json_input_without_file_or_h5py(monkeypatch, tmp_path):
    """setup_calculation with "filename": false and an .npz trial file."""
    from pauxy_jax.qmc.calc import setup_calculation

    _no_h5py(monkeypatch)
    monkeypatch.chdir(tmp_path)
    af = setup_calculation({
        "system": {"name": "Hubbard", "nx": 4, "ny": 4, "nup": 7,
                   "ndown": 7, "U": 4},
        "qmc": {"dt": 0.01, "nsteps": 2, "blocks": 1, "nwalkers": 4,
                "rng_seed": 8},
        "trial": {"name": "hartree_fock", "filename": os.path.join(
            ROOT, "tests", "data", "hubbard4x4_uhf_continuous.npz")},
        "estimators": {"filename": False},
    })
    assert af.trial.name == "file"
    assert np.isfinite(af.run().real).all()
    assert os.listdir(tmp_path) == []


@pytest.mark.unit
def test_thermal_driver_without_file_or_h5py(monkeypatch, tmp_path):
    from pauxy_jax.models import make_hubbard
    from pauxy_jax.models.thermal_trial import make_one_body_trial
    from pauxy_jax.qmc import QMCOpts
    from pauxy_jax.qmc.thermal_afqmc import ThermalAFQMC

    _no_h5py(monkeypatch)
    monkeypatch.chdir(tmp_path)
    ham = make_hubbard(nup=2, ndown=2, U=4.0, nx=2, ny=2)
    trial = make_one_body_trial(ham, 0.5, 0.05)
    qmc = QMCOpts(nwalkers=4, dt=0.05, nsteps=1, nblocks=1, npop_control=1,
                  rng_seed=8, beta=0.5)
    rows = ThermalAFQMC(ham, trial, qmc, filename=False).run()
    assert np.isfinite(np.asarray(rows).real).all()
    assert os.listdir(tmp_path) == []


# ----------------------------------------------------------------------------
# compile cache location
# ----------------------------------------------------------------------------

@pytest.mark.unit
def test_compile_cache_follows_environment(monkeypatch, tmp_path):
    from pauxy_jax import config

    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(config.jax.config, "update",
                        lambda *a: calls.append(a))
    assert config.enable_compile_cache() == str(tmp_path)
    assert calls == []


@pytest.mark.unit
def test_compile_cache_defaults_inside_checkout(monkeypatch):
    from pauxy_jax import config

    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(config.jax.config, "update",
                        lambda *a: calls.append(a))
    path = config.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    ignored = open(os.path.join(ROOT, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored
