#!/usr/bin/env python
"""End-to-end smoke test of pauxy-jax on one NVIDIA GPU.

    python chip_smoke.py            # every phase, one GPU
    python chip_smoke.py --chips 4  # the four-GPU sharded phase only

Phases (each prints one line with its numbers and fails the run on error):

  a  batched kernels at the benchmark widths against numpy float64
  b  4x4 Hubbard U=4 (7,7), 1024 walkers, from a JSON input through
     ``setup_calculation``, continuous and discrete HS, against the serial
     oracle's equilibrated mean
  c  Generic nmo=128, naux=512, (16,16), 1024 walkers
  d  thermal UEG rs=1, ecut=4 (M=93), beta=2, 256 walkers
  e  one tiny block of each of ten Hamiltonian / trial families

``--chips 4`` runs phase (b) on a 4-way walker mesh and phase (c) on a 2x2
walker x chol mesh, each against the same run on one GPU.

The last line of standard output is one JSON object naming the device.
Without a GPU, or without the pauxy_jax package beside this script, it
exits non-zero before printing it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "tests", "data")

# Walker counts of the benchmark configurations, and the edge of the plain
# f32 GEMM that shows which algorithm each matmul-precision tier gets.
NW = 1024
NW_THERMAL = 256
GEMM_N = 4096


def log(msg: str):
    print(msg, flush=True)


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    return 2


def _rand_c(rng, *shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _relerr(got, ref) -> float:
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def _check(name: str, err: float, tol: float, reason: str):
    log(f"  {name}: err={err:.3e} tol={tol:.0e} ({reason})")
    if not err <= tol:
        raise AssertionError(f"{name}: error {err:.3e} above {tol:.0e}")


# ----------------------------------------------------------------------------
# (a) kernels
# ----------------------------------------------------------------------------

def _numpy_cpqr(a):
    """Textbook column-pivoted Householder QR of one matrix in float64:
    returns the pivot order (the reference ops/cpqr's order is checked
    against)."""
    r = np.array(a, dtype=complex)
    m = r.shape[-1]
    perm = np.arange(m)
    for k in range(m):
        p = k + int(np.argmax(np.sum(np.abs(r[k:, k:]) ** 2, axis=0)))
        r[:, [k, p]] = r[:, [p, k]]
        perm[[k, p]] = perm[[p, k]]
        x = np.zeros(m, complex)
        x[k:] = r[k:, k]
        phase = x[k] / abs(x[k]) if abs(x[k]) > 0 else 1.0
        v = x.copy()
        v[k] += phase * np.linalg.norm(x)
        vsq = np.vdot(v, v).real
        if vsq > 0:
            r -= np.outer(v, v.conj() @ r) * (2.0 / vsq)
    return perm


def phase_a():
    import jax
    import jax.numpy as jnp

    from pauxy_jax import config
    from pauxy_jax.estimators.local_energy import _exx
    from pauxy_jax.ops import clinalg, cpqr, greens
    from pauxy_jax.propagation.generic import apply_exponential_taylor

    rng = np.random.default_rng(0)
    nw = NW
    f32 = "f32 on a well-conditioned batch: ~n eps kappa, x10 margin"

    # A plain f32 GEMM at JAX's own default precision, then at each tier of
    # the driver's ladder, shows which algorithm each setting gets.
    big = rng.normal(size=(GEMM_N, GEMM_N)).astype(np.float32)
    big_ref = big.astype(np.float64) @ big.astype(np.float64)[:, :256]
    big_d = jnp.asarray(big)

    def gemm_probe(label):
        mm = jax.jit(lambda a: a @ a)
        g = mm(big_d).block_until_ready()
        t0 = time.perf_counter()
        for _ in range(5):
            g = mm(big_d)
        g.block_until_ready()
        tg = (time.perf_counter() - t0) / 5
        gerr = _relerr(np.asarray(g)[:, :256], big_ref)
        log(f"  {label}: f32 GEMM {GEMM_N}^3 err={gerr:.2e} "
            f"{2 * GEMM_N ** 3 / tg / 1e12:.1f} TFLOP/s")

    gemm_probe("JAX default matmul precision")
    # Everything below runs at the drivers' default tier.
    config.set_matmul_precision("float32")

    # Batched complex solve / slogdet, [1024, n, n] c64.
    for n in (7, 16, 32, 64):
        s = (_rand_c(rng, nw, n, n) / np.sqrt(2 * n)
             + 2.0 * np.eye(n)).astype(np.complex64)
        y = _rand_c(rng, nw, n, 8).astype(np.complex64)
        x = clinalg.solve(jnp.asarray(s), jnp.asarray(y))
        ld = clinalg.slogdet(jnp.asarray(s))
        s64, y64 = s.astype(np.complex128), y.astype(np.complex128)
        _check(f"solve [{nw},{n},{n}] c64", _relerr(x, np.linalg.solve(
            s64, y64)), 1e-4, f32)
        sign, logabs = np.linalg.slogdet(s64)
        dl = np.asarray(ld, np.complex128) - (logabs + np.log(sign))
        dl = dl.real + 1j * (np.mod(dl.imag + np.pi, 2 * np.pi) - np.pi)
        _check(f"slogdet [{nw},{n},{n}] c64", float(np.abs(dl).max()), 1e-3,
               "f32 sum of n pivot logs, absolute")

    # Green's function at the Hubbard and Generic shapes.
    for m, n in ((16, 7), (128, 16)):
        psi = np.linalg.qr(_rand_c(rng, m, n))[0]
        phi = (psi[None] + 0.3 * _rand_c(rng, nw, m, n) / np.sqrt(m))
        gf = greens.greens_function(jnp.asarray(phi.astype(np.complex64)),
                                    jnp.asarray(psi.astype(np.complex64)))
        phi = phi.astype(np.complex64).astype(np.complex128)
        psi = psi.astype(np.complex64).astype(np.complex128)
        smat = np.einsum("wmi,mj->wij", phi, psi.conj())
        gh = np.linalg.solve(smat, np.swapaxes(phi, -1, -2))
        _check(f"greens Ghalf [{nw},{m},{n}]", _relerr(gf.Ghalf, gh), 1e-4,
               f32)

    # Order-6 Taylor expm-apply at every matmul-precision tier. The numpy
    # reference covers the first 64 walkers.
    m, n, nref = 128, 32, 64
    vhs = (0.3 / np.sqrt(m) * _rand_c(rng, nw, m, m)).astype(np.complex64)
    phi = _rand_c(rng, nw, m, n).astype(np.complex64)
    tmp = acc = phi[:nref].astype(np.complex128)
    v64 = vhs[:nref].astype(np.complex128)
    for k in range(1, 7):
        tmp = np.matmul(v64, tmp) / k
        acc = acc + tmp
    tols = {
        "float32": (1e-5, "full f32: ~sqrt(m) eps"),
        "tensorfloat32": (5e-3, "10-bit mantissa products"),
    }
    vhs_d, phi_d = jnp.asarray(vhs), jnp.asarray(phi)
    try:
        for tier, (tol, reason) in tols.items():
            config.set_matmul_precision(tier)
            fn = jax.jit(apply_exponential_taylor)
            out = fn(vhs_d, phi_d).block_until_ready()
            t0 = time.perf_counter()
            for _ in range(5):
                out = fn(vhs_d, phi_d)
            out.block_until_ready()
            dt = (time.perf_counter() - t0) / 5
            err = _relerr(np.asarray(out)[:nref], acc)
            log(f"  tier {tier}: taylor [{nw},{m},{m}]x[{m},{n}] "
                f"{dt * 1e3:.3f} ms")
            gemm_probe(f"tier {tier}")
            _check(f"taylor order 6, tier {tier}", err, tol, reason)
    finally:
        config.set_matmul_precision("float32")

    # Column-pivoted QR at the thermal fold shape [256, 93, 93]. Graded
    # columns make the pivot order well defined.
    m, nb = 93, 256
    grade = 10.0 ** (-np.linspace(0, 4, m))
    a = _rand_c(rng, nb, m, m) * grade[rng.permutation(m)][None, None, :]
    a = a.astype(np.complex64)
    q, r, perm = (np.asarray(x) for x in cpqr.cpqr(jnp.asarray(a)))
    a64 = a.astype(np.complex128)
    res = max(np.abs(a64[b][:, perm[b]] - q[b] @ r[b]).max()
              / np.abs(a64[b]).max() for b in range(nb))
    orth = max(np.abs(q[b].conj().T @ q[b] - np.eye(m)).max()
               for b in range(nb))
    _check(f"cpqr A P - Q R [{nb},{m},{m}]", float(res), 1e-4,
           "f32 Householder: ~m eps, x20 margin")
    _check(f"cpqr Q^H Q - I [{nb},{m},{m}]", float(orth), 1e-4,
           "f32 Householder: ~m eps, x20 margin")
    same = sum(bool((perm[b] == _numpy_cpqr(a64[b])).all())
               for b in range(16))
    _check("cpqr pivot orders unlike float64 (of 16 matrices)", 16 - same, 2,
           "f32 downdated norms may swap a near-tie")

    # Exchange energy above the supermatrix cap (n=32, M=300: nM > 8192),
    # through the Cholesky-chunked path.
    n, m, nx = 32, 300, 1200
    rchol = (rng.normal(size=(nx, n, m)) / m).astype(np.float32)
    gh = (_rand_c(rng, nw, n, m) / np.sqrt(m)).astype(np.complex64)
    ex = np.asarray(jax.jit(_exx)(jnp.asarray(rchol), jnp.asarray(gh)))
    t = np.einsum("xim,wjm->wxij", rchol.astype(np.float64),
                  gh[:8].astype(np.complex128))
    ref = np.einsum("wxij,wxji->w", t, t)
    _check(f"exchange [{nw},{n},{m}] x {nx} (chunked)",
           _relerr(ex[:8], ref), 1e-3, "f32 sums of X n^2 terms")

    _sweep_vs_scan()


def _sweep_vs_scan():
    """The Triton site-sweep kernel against the scan sweep at the 4x4
    flagship shape, one sweep from the same real walkers and key."""
    import jax

    from pauxy_jax.models import free_electron_trial, make_hubbard
    from pauxy_jax.propagation.hirsch import make_hirsch
    from pauxy_jax.walkers import init_walkers

    ham = make_hubbard(nup=7, ndown=7, U=4.0, nx=4, ny=4)
    trial = free_electron_trial(ham)
    state = init_walkers(trial, NW)
    rng = np.random.default_rng(3)
    state = state.replace(
        phia=state.phia + 0.1 * rng.normal(size=state.phia.shape),
        phib=state.phib + 0.1 * rng.normal(size=state.phib.shape))
    key = jax.random.key(5)
    out = {}
    for kernel in ("scan", "triton"):
        prop = make_hirsch(ham, trial, 0.01, sweep_kernel=kernel)
        sweep = jax.jit(prop._site_sweep)
        sweep(trial, state, key)[0].weight.block_until_ready()
        t0 = time.perf_counter()
        for _ in range(10):
            new, fields = sweep(trial, state, key)
        new.weight.block_until_ready()
        out[kernel] = (new, np.asarray(fields),
                       (time.perf_counter() - t0) / 10)
    (s0, f0, t0), (s1, f1, t1) = out["scan"], out["triton"]
    same = (f0 == f1).all(axis=1)
    log(f"  site sweep [{NW},16,7]: scan {t0 * 1e3:.3f} ms, "
        f"triton kernel {t1 * 1e3:.3f} ms per sweep")
    _check("sweep walkers whose field choices differ", int((~same).sum()),
           2, "f32 reassociation may flip a choice on a near-tie")
    _check("sweep weights (same choices)", _relerr(
        np.asarray(s1.weight)[same], np.asarray(s0.weight)[same]), 1e-4,
        "f32 rank-1 updates summed in another order")


# ----------------------------------------------------------------------------
# (b) 4x4 Hubbard against the oracle
# ----------------------------------------------------------------------------

def _hubbard_input(hs: str, nwalkers: int, nblocks: int) -> dict:
    return {
        "system": {"name": "Hubbard", "nx": 4, "ny": 4, "nup": 7,
                   "ndown": 7, "U": 4},
        "qmc": {"dt": 0.01, "nsteps": 10, "blocks": nblocks,
                "nwalkers": nwalkers, "rng_seed": 8, "stabilise_freq": 10,
                "pop_control_freq": 1},
        "trial": {"name": "hartree_fock",
                  "filename": os.path.join(
                      DATA, f"hubbard4x4_uhf_{hs}.npz")},
        "propagator": {"hubbard_stratonovich": hs},
        "estimators": {"filename": False,
                       "mixed": {"energy_eval_freq": 1}},
    }


def _oracle(hs: str):
    g = np.load(os.path.join(DATA, f"hubbard4x4_uhf_{hs}.npz"))
    et = np.asarray(g["etotal_blocks"]).real
    eq = et[len(et) // 3:]
    return float(eq.mean()), float(eq.std(ddof=1) / np.sqrt(len(eq)))


def _batch_stderr(e, nbatch=10) -> float:
    """Standard error from batch means (blocks are autocorrelated)."""
    b = np.array_split(np.asarray(e), nbatch)
    means = np.array([x.mean() for x in b])
    return float(means.std(ddof=1) / np.sqrt(nbatch))


def phase_b(neqlb=35, nmeasure=100):
    from pauxy_jax.qmc.calc import setup_calculation

    for hs in ("continuous", "discrete"):
        t0 = time.perf_counter()
        af = setup_calculation(_hubbard_input(hs, NW, neqlb + nmeasure))
        af.verbose = False
        af.reporter.verbose = False
        rows = af.run()
        wall = time.perf_counter() - t0
        e = rows[neqlb:, 5].real
        if not np.isfinite(rows[:, :10].real).all():
            raise AssertionError(f"hubbard {hs}: non-finite rows")
        mean, se = float(e.mean()), _batch_stderr(e)
        omean, ose = _oracle(hs)
        dev = abs(mean - omean) / np.hypot(se, ose)
        log(f"  hubbard 4x4 {hs}: ETotal={mean:.5f}+-{se:.5f} "
            f"oracle={omean:.5f}+-{ose:.5f} dev={dev:.2f} sigma "
            f"(tol 3, combined sigma) blocks={len(rows)} "
            f"fast_block={getattr(af, 'use_fast_block', False)} "
            f"wall={wall:.1f}s")
        if not dev <= 3.0:
            raise AssertionError(f"hubbard {hs}: {dev:.2f} sigma from oracle")


# ----------------------------------------------------------------------------
# (c) Generic at nmo=128
# ----------------------------------------------------------------------------

def _generic_driver(nblocks=3):
    from pauxy_jax.models.generic import make_generic
    from pauxy_jax.models.trial import rhf_identity_trial
    from pauxy_jax.qmc import AFQMC, QMCOpts

    nmo, na, nx = 128, 16, 512
    rng = np.random.default_rng(7)
    chol = rng.normal(scale=0.01, size=(nmo, nmo, nx))
    chol = 0.5 * (chol + chol.transpose(1, 0, 2))
    h1 = rng.normal(scale=0.1, size=(nmo, nmo))
    h1 = 0.5 * (h1 + h1.T)
    ham = make_generic((na, na), np.stack([h1, h1]), chol, ecore=0.0)
    trial = rhf_identity_trial(ham)
    qmc = QMCOpts(nwalkers=NW, dt=0.005, nsteps=10, nblocks=nblocks,
                  nstblz=5, npop_control=1, rng_seed=8)
    return AFQMC(ham, trial, qmc,
                 estimator_options={"mixed": {"energy_eval_freq": 1}},
                 filename=False)


def _check_rows(name, rows, nwalkers):
    r = np.asarray(rows).real
    if not np.isfinite(r[:, :10]).all():
        raise AssertionError(f"{name}: non-finite rows")
    w = r[:, 2]
    if not ((w > 0.1 * nwalkers) & (w < 10 * nwalkers)).all():
        raise AssertionError(f"{name}: weights {w} not O(nwalkers)")


def phase_c():
    t0 = time.perf_counter()
    af = _generic_driver()
    rows = af.run()
    _check_rows("generic", rows, NW)
    log(f"  generic nmo=128 naux=512 (16,16) {NW} walkers: "
        f"ETotal={np.round(rows[:, 5].real, 4).tolist()} "
        f"Weight={np.round(rows[:, 2].real, 1).tolist()} "
        f"wall={time.perf_counter() - t0:.1f}s")


# ----------------------------------------------------------------------------
# (d) thermal UEG
# ----------------------------------------------------------------------------

def phase_d():
    from pauxy_jax.models import make_ueg
    from pauxy_jax.models.thermal_trial import make_one_body_trial
    from pauxy_jax.qmc import QMCOpts
    from pauxy_jax.qmc.thermal_afqmc import ThermalAFQMC

    t0 = time.perf_counter()
    nw, beta, dt = NW_THERMAL, 2.0, 0.05
    ham = make_ueg(nup=7, ndown=7, rs=1.0, ecut=4.0)
    trial = make_one_body_trial(ham, beta, dt, mu=0.9)
    qmc = QMCOpts(nwalkers=nw, dt=dt, nsteps=1, nblocks=2, beta=beta,
                  npop_control=1, rng_seed=8)
    af = ThermalAFQMC(ham, trial, qmc, filename=False)
    rows = np.asarray(af.run()).real
    if not np.isfinite(rows).all():
        raise AssertionError("thermal: non-finite rows")
    log(f"  thermal UEG M={ham.nbasis} beta={beta} {nw} walkers: "
        f"ETotal={np.round(rows[:, 5], 4).tolist()} "
        f"wall={time.perf_counter() - t0:.1f}s")


# ----------------------------------------------------------------------------
# (e) every family, one tiny block
# ----------------------------------------------------------------------------

def _tiny(name, ham, trial, **kw):
    from pauxy_jax.qmc import AFQMC, QMCOpts

    qmc = QMCOpts(nwalkers=8, dt=0.005, nsteps=3, nblocks=1, nstblz=3,
                  npop_control=1, rng_seed=8)
    af = AFQMC(ham, trial, qmc,
               estimator_options={"mixed": {"energy_eval_freq": 3}},
               filename=False, **kw)
    _check_rows(name, af.run(), 8)


def _tiny_thermal(name, ham, beta, mu=None, **kw):
    from pauxy_jax.models.thermal_trial import make_one_body_trial
    from pauxy_jax.qmc import QMCOpts
    from pauxy_jax.qmc.thermal_afqmc import ThermalAFQMC

    dt = 0.05
    trial = make_one_body_trial(ham, beta, dt, mu=mu)
    qmc = QMCOpts(nwalkers=4, dt=dt, nsteps=1, nblocks=1, npop_control=1,
                  rng_seed=8, beta=beta)
    rows = ThermalAFQMC(ham, trial, qmc, filename=False, **kw).run()
    if not np.isfinite(np.asarray(rows).real).all():
        raise AssertionError(f"{name}: non-finite rows")


def phase_e():
    from pauxy_jax.models import (free_electron_trial, make_hubbard,
                                  make_pw_fft, make_ueg, rhf_identity_trial)
    from pauxy_jax.models.generic import make_generic
    from pauxy_jax.models.ghf import ghf_trial_from_uhf
    from pauxy_jax.models.hubbard_holstein import make_hubbard_holstein
    from pauxy_jax.models.multi_coherent import multi_coherent_trial
    from pauxy_jax.utils.transfer import to_host

    def hubbard():
        ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
        _tiny("hubbard", ham, free_electron_trial(ham))

    def hubbard_discrete():
        ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
        _tiny("hubbard_discrete", ham, free_electron_trial(ham),
              propagator_options={"hubbard_stratonovich": "discrete"})

    def generic():
        rng = np.random.default_rng(7)
        nmo = 12
        chol = rng.normal(scale=0.02, size=(nmo, nmo, 30))
        chol = 0.5 * (chol + chol.transpose(1, 0, 2))
        h1 = rng.normal(scale=0.1, size=(nmo, nmo))
        ham = make_generic((3, 3), np.stack([h1 + h1.T] * 2) / 2, chol,
                           ecore=0.0)
        _tiny("generic", ham, rhf_identity_trial(ham))

    def ueg():
        ham = make_ueg(nup=7, ndown=7, rs=1.0, ecut=1.0)
        _tiny("ueg", ham, rhf_identity_trial(ham))

    def pw_fft():
        ham = make_pw_fft(nup=2, ndown=2, rs=1.0, ecut=0.5)
        _tiny("pw_fft", ham, rhf_identity_trial(ham))

    def ghf():
        ham = make_hubbard(nup=3, ndown=3, U=4.0, nx=3, ny=3)
        fe = free_electron_trial(ham)
        trial = ghf_trial_from_uhf(ham, np.asarray(to_host(fe.psia)),
                                   np.asarray(to_host(fe.psib)))
        _tiny("ghf", ham, trial,
              propagator_options={"hubbard_stratonovich": "discrete"})

    def multi_coherent():
        ham = make_hubbard_holstein(nup=1, ndown=1, U=4.0, nx=3, ny=1,
                                    w0=0.8, lmbda=0.5)
        _tiny("multi_coherent", ham, multi_coherent_trial(ham))

    def thermal():
        _tiny_thermal("thermal", make_ueg(nup=1, ndown=1, rs=1.0, ecut=0.5),
                      0.25, mu=0.245)

    def thermal_low_rank():
        _tiny_thermal("thermal_low_rank",
                      make_ueg(nup=1, ndown=1, rs=1.0, ecut=0.5), 0.25,
                      mu=0.245, walker_options={"low_rank": True})

    def thermal_discrete():
        _tiny_thermal(
            "thermal_discrete", make_hubbard(nup=2, ndown=2, U=4.0, nx=2,
                                             ny=2), 0.5,
            propagator_options={"hubbard_stratonovich": "discrete"})

    families = [hubbard, hubbard_discrete, generic, ueg, pw_fft, thermal,
                ghf, multi_coherent, thermal_low_rank, thermal_discrete]
    for fn in families:
        t0 = time.perf_counter()
        fn()
        log(f"  family {fn.__name__}: ok ({time.perf_counter() - t0:.1f}s)")


# ----------------------------------------------------------------------------
# four GPUs: sharded against one GPU
# ----------------------------------------------------------------------------

def _sharded_pair(make, shard):
    """Rows of the same run on one GPU and on a mesh of four."""
    rows = []
    for sharded in (False, True):
        af = make()
        af.verbose = False
        af.reporter.verbose = False
        if sharded:
            shard(af)
        rows.append(np.asarray(af.run()).real)
    return rows


def phase_sharded():
    from pauxy_jax.parallel import mesh as pmesh

    def hubbard(pop_freq):
        from pauxy_jax.qmc.calc import setup_calculation

        opts = _hubbard_input("continuous", NW, 1)
        opts["qmc"]["pop_control_freq"] = pop_freq
        return setup_calculation(opts)

    def shard_walkers(af):
        af.state = pmesh.shard_walkers(af.state, pmesh.walker_mesh())

    def generic(pop_freq):
        af = _generic_driver(nblocks=1)
        af.qmc.npop_control = pop_freq
        return af

    def shard_walker_chol(af):
        m2 = pmesh.walker_chol_mesh(2)
        af.ham, af.trial, af.prop = pmesh.shard_generic(
            af.ham, af.trial, af.prop, m2)
        af.state = pmesh.shard_walkers(af.state, m2)

    cases = [("hubbard 4x4 continuous, 4-way walker mesh", hubbard,
              shard_walkers),
             ("generic nmo=128, 2x2 walker x chol mesh", generic,
              shard_walker_chol)]
    # Without population control the runs differ only by f32 sums taken
    # in another order. With the comb every step, a parent choice flips
    # where a cumulative weight lies within rounding of a comb tooth
    # (about one flip per ten steps at 1024 walkers), which swaps one
    # walker for another and moves the block averages by up to ~1e-2.
    variants = [(100, 1e-5, "f32 sums reordered across cards"),
                (1, 2e-2, "comb every step: a parent choice may flip on a "
                          "rounding-level tie, swapping one walker")]
    for label, make, shard in cases:
        for pop_freq, tol, reason in variants:
            one, four = _sharded_pair(lambda: make(pop_freq), shard)
            log(f"  {label}, pop control every {pop_freq} steps: "
                f"ETotal {four[:, 5].tolist()} vs 1 GPU {one[:, 5].tolist()}")
            _check(f"{label} rows (pop every {pop_freq})",
                   _relerr(four[:, 1:10], one[:, 1:10]), tol, reason)


PHASES = {"a": phase_a, "b": phase_b, "c": phase_c, "d": phase_d,
          "e": phase_e}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--chips", type=int, choices=(1, 4), default=1)
    parser.add_argument("--phase", action="append", choices=sorted(PHASES),
                        help="run only these one-GPU phases (repeatable)")
    args = parser.parse_args(argv)

    sys.path.insert(0, HERE)
    try:
        import pauxy_jax
    except ImportError:
        return _fail("the pauxy_jax package is not beside this script")
    if os.path.dirname(os.path.dirname(
            os.path.abspath(pauxy_jax.__file__))) != HERE:
        return _fail("pauxy_jax was imported from outside this checkout")

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        return _fail(f"no GPU: JAX found {devices}")
    if len(devices) < args.chips:
        return _fail(f"--chips {args.chips} needs {args.chips} GPUs, "
                     f"JAX found {len(devices)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(f"gpu: {smi.stdout.strip()}")
    log(f"jax {jax.__version__} devices: {devices}")

    from pauxy_jax import config

    log(f"compile cache: {config.enable_compile_cache()}")
    if args.chips == 4:
        phases = [("sharded", phase_sharded)]
    else:
        phases = [(k, PHASES[k]) for k in (args.phase or sorted(PHASES))]
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"phase {name}:")
        try:
            fn()
        except Exception as e:  # noqa: BLE001 -- report, then fail the run
            log(f"phase {name} FAILED after {time.perf_counter() - t0:.1f}s:"
                f" {type(e).__name__}: {e}")
            return 1
        log(f"phase {name} ok ({time.perf_counter() - t0:.1f}s)")

    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
