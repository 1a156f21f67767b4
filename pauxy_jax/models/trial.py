"""Single-determinant (UHF-style) trial wavefunctions.

Batched counterpart of ``pauxy/trial_wavefunction/free_electron.py:8-90``
and ``pauxy/trial_wavefunction/uhf.py:10-255`` plus the single-determinant
slice of ``multi_slater.py``. Trials are built host-side (numpy/scipy — this
is setup, not the hot path) and stored as a frozen pytree of device arrays.

The trial's Green's function is G_sigma = conj(psi) (psi^T conj(psi))^{-1}
psi^T (``uhf.py:92-96`` via gab().T).
"""

from __future__ import annotations

from typing import Any

import numpy as np
from pauxy_jax.utils import pytree as struct

from pauxy_jax import config


@struct.dataclass
class SingleDetTrial:
    """Single Slater determinant trial |psi_T> = |psi_a> x |psi_b>.

    ``rchola``/``rcholb`` are the half-rotated Cholesky tensors used by the
    ab-initio (Generic) fast force-bias/energy paths
    (``multi_slater.py:267-420``); None for lattice models.
    """

    psia: Any              # [M, na]
    psib: Any              # [M, nb]
    inita: Any             # [M, na] initial walker orbitals
    initb: Any             # [M, nb]
    rchola: Any = None     # [naux, na, M] half-rotated Cholesky (alpha)
    rcholb: Any = None     # [naux, nb, M]
    rh1a: Any = None       # [na, M] half-rotated one-body (alpha)
    rh1b: Any = None       # [nb, M]
    shift: Any = None      # [M] coherent-state phonon displacement (HH)
    # --- Generic local-energy variant precomputes (multi_slater.py:282-362):
    # exact_eri: half-rotated 4-index ERIs v_{ipjq} per spin channel.
    eri_aa: Any = None     # [na, M, na, M]
    eri_bb: Any = None     # [nb, M, nb, M]
    eri_ab: Any = None     # [na, M, nb, M]
    # pno: per-pair truncated SVD factors, zero-padded to a fixed rank cap:
    # each channel is (idx_i [n], idx_j [n], coeff [n], U [n, M, k], VT [n, k, M]).
    pno_aa: Any = None
    pno_bb: Any = None
    pno_ab: Any = None
    # stochastic-RI control variate / pno base terms: the trial's own Ghalf
    # and its exact (ecoul0, exxa0, exxb0).
    ghalf0a: Any = None    # [na, M]
    ghalf0b: Any = None    # [nb, M]
    # Exchange supermatrix C[(j m), (i m')] = sum_x rchol[x,i,m] rchol[x,j,m']
    # ([n*M, n*M], walker-independent): exx_w = vec(Ghalf_w)^T C vec(Ghalf_w)
    # as ONE dense matmul — replaces the [w, X, n, n] intermediate /
    # chunked scan entirely when (n*M)^2 fits (estimators/local_energy._exx).
    exx_supera: Any = None  # [na*M, na*M]
    exx_superb: Any = None  # [nb*M, nb*M]
    e0_terms: Any = struct.field(pytree_node=False, default=None)
    # Host-side (numpy) trial Green's function; setup-only, never on device.
    G_host: Any = struct.field(pytree_node=False, default=None)
    etrial: float = struct.field(pytree_node=False, default=0.0)
    name: str = struct.field(pytree_node=False, default="single_det")

    @property
    def nup(self) -> int:
        return self.psia.shape[1]

    @property
    def ndown(self) -> int:
        return self.psib.shape[1]

    @property
    def nbasis(self) -> int:
        return self.psia.shape[0]


def trial_density_matrix(psia: np.ndarray, psib: np.ndarray) -> np.ndarray:
    """G[2, M, M] with G_s = conj(psi_s) (psi_s^T conj(psi_s))^{-1} psi_s^T."""
    out = []
    for psi in (psia, psib):
        if psi.shape[1] == 0:
            out.append(np.zeros((psi.shape[0], psi.shape[0]), dtype=psi.dtype))
            continue
        ovlp = psi.T @ psi.conj()
        out.append(psi.conj() @ np.linalg.solve(ovlp.T, psi.T))
    return np.stack(out)


def _eigh_lowest(h: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Lowest-n eigenpairs of a hermitian matrix, ascending."""
    e, v = np.linalg.eigh(h)
    return e[:n], v[:, :n]


def _finalize(ham, psia, psib, prec, name: str) -> SingleDetTrial:
    from pauxy_jax.utils.transfer import to_device

    dtype = prec.cplx
    psia = np.asarray(psia, dtype=dtype)
    psib = np.asarray(psib, dtype=dtype)
    g = trial_density_matrix(psia, psib)
    from pauxy_jax.estimators import local_energy as le

    etrial = float(np.real(le.local_energy_G_host(ham, g)[0]))
    extras = {}
    if getattr(ham, "name", "") == "Generic":
        # Half-rotation: rchol[x, a, m] = sum_p conj(psi[p, a]) L[p, m, x]
        # (multi_slater.py:267-420, as a single einsum) and the half-rotated
        # one-body rh1[a, m] = sum_p conj(psi[p, a]) H1[p, m].
        chol = np.asarray(ham.chol)
        h1 = np.asarray(ham.H1)
        rca = np.einsum("pa,pmx->xam", psia.conj(), chol, optimize=True)
        rcb = np.einsum("pa,pmx->xam", psib.conj(), chol, optimize=True)

        def natural(arr):
            """Store REAL when the tensor is genuinely real (molecular
            Hamiltonians) — halves the real matmuls and memory traffic of every
            downstream contraction (ops/contract.cr_einsum); complex only
            for k-point/twisted data."""
            if np.iscomplexobj(arr) and np.abs(arr.imag).max() == 0.0:
                arr = arr.real
            return arr.astype(prec.real if not np.iscomplexobj(arr)
                              else dtype)

        rh1a = psia.conj().T @ h1[0]
        rh1b = psib.conj().T @ h1[1]
        extras = dict(
            rchola=to_device(natural(rca)),
            rcholb=to_device(natural(rcb)),
            rh1a=to_device(natural(rh1a)),
            rh1b=to_device(natural(rh1b)),
        )
        for spin, rc in (("a", rca), ("b", rcb)):
            sup = _exx_supermatrix(rc)
            if sup is not None:
                extras[f"exx_super{spin}"] = to_device(natural(sup))
        extras.update(_generic_variant_precomputes(ham, psia, psib, rca, rcb,
                                                   g, dtype))
    from pauxy_jax.utils.transfer import HostArray

    psia_d = to_device(psia)
    psib_d = to_device(psib)
    return SingleDetTrial(
        psia=psia_d,
        psib=psib_d,
        inita=psia_d,
        initb=psib_d,
        G_host=HostArray(g.astype(dtype)),
        etrial=etrial,
        name=name,
        **extras,
    )


# Elements cap of one exchange supermatrix: (n*M)^2 <= 2^26 (268 MB f32).
# Beyond this the chunked-scan _exx path takes over.
EXX_SUPER_MAX_ELEMS = 2 ** 26


def _exx_supermatrix(rc: np.ndarray) -> np.ndarray | None:
    """C[(j m), (i m')] = sum_x rchol[x, i, m] rchol[x, j, m'].

    Walker-independent [n*M, n*M] symmetric matrix such that
    exx_w = vec(Ghalf_w)^T C vec(Ghalf_w) (no conjugation — exx is the
    trace of T^2, not T T^dagger). Returns None when over the size cap.
    """
    x, n, m = rc.shape
    if (n * m) ** 2 > EXX_SUPER_MAX_ELEMS or n == 0:
        return None
    rcf = rc.reshape(x, n * m).astype(
        np.complex128 if np.iscomplexobj(rc) else np.float64)
    # gram4[i, m, j, m'] = sum_x rc[x, i, m] rc[x, j, m']; the target
    # C4[j, m, i, m'] = gram4[i, m, j, m'] with the ELECTRON indices
    # swapped but each orbital index staying put -> transpose (2, 1, 0, 3).
    gram = rcf.T @ rcf                       # [(i m), (j m')]
    c4 = gram.reshape(n, m, n, m).transpose(2, 1, 0, 3)
    return np.ascontiguousarray(c4.reshape(n * m, n * m))


def _generic_variant_precomputes(ham, psia, psib, rca, rcb, g, dtype) -> dict:
    """Setup tensors for the exact-ERI / PNO / stochastic-RI local-energy
    variants (host-side numpy; ``multi_slater.py:282-362``)."""
    from pauxy_jax.utils.transfer import to_device

    extras = {}
    need_eri = getattr(ham, "exact_eri", False) or getattr(ham, "pno", False)
    need_g0 = getattr(ham, "pno", False) or (
        getattr(ham, "stochastic_ri", False)
        and getattr(ham, "control_variate", False)
    )
    if need_eri:
        # v_{ipjq} = sum_X rchol[X,i,p] rchol'[X,j,q] (multi_slater.py:288-290).
        eri_aa = np.einsum("xip,xjq->ipjq", rca, rca, optimize=True)
        eri_bb = np.einsum("xip,xjq->ipjq", rcb, rcb, optimize=True)
        eri_ab = np.einsum("xip,xjq->ipjq", rca, rcb, optimize=True)
        if getattr(ham, "exact_eri", False):
            extras.update(
                eri_aa=to_device(eri_aa.astype(dtype)),
                eri_bb=to_device(eri_bb.astype(dtype)),
                eri_ab=to_device(eri_ab.astype(dtype)),
            )
    if need_g0:
        # Trial's own half-rotated Green's function Ghalf0 = (psi^dag psi)^-1
        # psi^dag at phi = psi, i.e. rows of the pseudo-inverse.
        g0a = np.linalg.solve(psia.conj().T @ psia, psia.conj().T)
        g0b = (
            np.linalg.solve(psib.conj().T @ psib, psib.conj().T)
            if psib.shape[1]
            else np.zeros((0, psib.shape[0]), dtype=dtype)
        )
        xa = np.einsum("xam,am->x", rca, g0a, optimize=True)
        xb = np.einsum("xam,am->x", rcb, g0b, optimize=True)
        x = xa + xb
        ecoul0 = np.dot(x, x)
        ta = np.einsum("xim,jm->xij", rca, g0a, optimize=True)
        tb = np.einsum("xim,jm->xij", rcb, g0b, optimize=True)
        exxa0 = np.einsum("xij,xji->", ta, ta, optimize=True)
        exxb0 = np.einsum("xij,xji->", tb, tb, optimize=True)
        extras.update(
            ghalf0a=to_device(g0a.astype(dtype)),
            ghalf0b=to_device(g0b.astype(dtype)),
            e0_terms=(complex(ecoul0), complex(exxa0), complex(exxb0)),
        )
    if getattr(ham, "pno", False):
        def pno_channel(eri, ni, nj, symmetric):
            idx_i, idx_j, coeff, us, vts, ranks = [], [], [], [], [], []
            for i in range(ni):
                jstart = i if symmetric else 0
                for j in range(jstart, nj):
                    u, s, vt = np.linalg.svd(eri[i, :, j, :])
                    keep = s > ham.thresh_pno
                    k = int(keep.sum())
                    idx_i.append(i)
                    idx_j.append(j)
                    coeff.append(0.5 if (symmetric and i == j) else 1.0)
                    us.append(u[:, keep] * np.sqrt(s[keep])[None, :])
                    vts.append(np.sqrt(s[keep])[:, None] * vt[keep, :])
                    ranks.append(k)
            kmax = max(max(ranks), 1)
            n = len(idx_i)
            m = eri.shape[1]
            upad = np.zeros((n, m, kmax), dtype=eri.dtype)
            vpad = np.zeros((n, kmax, m), dtype=eri.dtype)
            for t in range(n):
                upad[t, :, : ranks[t]] = us[t]
                vpad[t, : ranks[t], :] = vts[t]
            return (
                to_device(np.asarray(idx_i, np.int32)),
                to_device(np.asarray(idx_j, np.int32)),
                to_device(np.asarray(coeff).astype(dtype)),
                to_device(upad.astype(dtype)),
                to_device(vpad.astype(dtype)),
            )

        na, nb = psia.shape[1], psib.shape[1]
        extras.update(
            pno_aa=pno_channel(eri_aa, na, na, True),
            pno_bb=pno_channel(eri_bb, nb, nb, True),
            pno_ab=pno_channel(eri_ab, na, nb, False),
        )
    return extras


def trial_from_orbitals(ham, psi: np.ndarray, precision=None, name="file") -> SingleDetTrial:
    """Build a trial from explicit orbitals psi[M, nup+ndown] (UHF layout)."""
    prec = config.get_precision(precision)
    return _finalize(ham, psi[:, : ham.nup], psi[:, ham.nup :], prec, name)


def free_electron_trial(ham, precision=None) -> SingleDetTrial:
    """Occupy the lowest eigenvectors of the one-body Hamiltonian.

    Reference: ``pauxy/trial_wavefunction/free_electron.py:28-66``.
    """
    prec = config.get_precision(precision)
    h1 = np.asarray(getattr(ham, "T", None) if getattr(ham, "name", "") != "Generic" else ham.H1)
    _, va = _eigh_lowest(h1[0], ham.nup)
    _, vb = _eigh_lowest(h1[1], ham.ndown)
    return _finalize(ham, va, vb, prec, "free_electron")


def rhf_identity_trial(ham, precision=None) -> SingleDetTrial:
    """Identity (MO-basis RHF) trial: occupy the first nup/ndown orbitals.

    The reference's default guess for Generic systems
    (``trial_wavefunction/utils.py:38-60`` / ``hartree_fock.py:7-56``).
    """
    prec = config.get_precision(precision)
    eye = np.eye(ham.nbasis)
    return _finalize(ham, eye[:, : ham.nup], eye[:, : ham.ndown], prec, "hartree_fock")


def spin_project_init(ham, trial, init_walker: str | None = None):
    """Replace the walkers' INITIAL determinant with spin-symmetric
    orbitals — natural orbitals of the spin-summed trial 1-RDM, or the
    one-body eigenvectors with ``init_walker='free_electron'``. The trial
    itself (and every overlap/energy it enters) is unchanged; only
    ``inita``/``initb`` move. Reference: the ``spin_proj`` /
    ``init_walker`` options, ``trial_wavefunction/utils.py:123-144``.

    Returns (trial, noons) — natural-orbital occupation numbers
    (descending) or None for the free-electron variant.
    """
    from pauxy_jax.utils.transfer import to_device, to_host

    na, nb = ham.nup, ham.ndown
    if getattr(trial, "psia", None) is None and init_walker != "free_electron":
        # GHF / multi-coherent trials store psi in other layouts; the
        # natural-orbital variant needs spin-resolved [M, n] orbitals.
        raise NotImplementedError(
            "spin_proj natural orbitals need a spin-resolved trial; use "
            "init_walker='free_electron' for this trial type"
        )
    cdtype = np.asarray(to_host(trial.inita)).dtype
    noons = None
    if init_walker == "free_electron":
        # The reference reads system.H1[0] (trial_wavefunction/utils.py:133);
        # Hubbard-family models here expose the hopping matrix as T instead,
        # and PW_FFT stores only the diagonal single-particle energies.
        if getattr(ham, "H1", None) is not None:
            h1 = np.asarray(to_host(ham.H1))[0]
        elif getattr(ham, "T", None) is not None:
            h1 = np.asarray(to_host(ham.T))[0]
        elif getattr(ham, "sp_eigv", None) is not None:
            h1 = np.diag(np.asarray(to_host(ham.sp_eigv)))
        else:
            raise NotImplementedError(
                "spin_proj init_walker='free_electron' needs a one-body "
                f"matrix (H1/T/sp_eigv) on {type(ham).__name__}"
            )
        _, eigv = np.linalg.eigh(h1)
    else:
        psia = np.asarray(to_host(trial.psia))
        psib = np.asarray(to_host(trial.psib))
        if psia.ndim == 3:          # MSD: leading determinant
            psia, psib = psia[0], psib[0]

        def proj(p):
            return p @ np.linalg.inv(p.conj().T @ p) @ p.conj().T

        eigs, eigv = np.linalg.eigh(proj(psia) + proj(psib))
        ix = np.argsort(eigs)[::-1]
        noons = eigs[ix].real
        eigv = eigv[:, ix]
    trial = trial.replace(
        inita=to_device(np.ascontiguousarray(eigv[:, :na]).astype(cdtype)),
        initb=to_device(np.ascontiguousarray(eigv[:, :nb]).astype(cdtype)),
    )
    return trial, noons


def checkerboard_guess(nbasis: int, nup: int, ndown: int, nx: int, ny: int):
    """Antiferromagnetic checkerboard determinant (``uhf.py:194-213``)."""
    wfn = np.zeros((nbasis, nup + ndown), dtype=np.complex128)
    na = nb = 0
    for i in range(nbasis):
        x, y = i % nx, i // nx
        if (x + y) % 2 == 0 and na < nup:
            wfn[i, na] = 1.0
            na += 1
        elif nb < ndown:
            wfn[i, nup + nb] = -1.0
            nb += 1
    return wfn


def uhf_trial(
    ham,
    ueff: float = 0.4,
    ninitial: int = 10,
    nconv: int = 5000,
    alpha: float = 0.5,
    deps: float = 1e-8,
    seed: int | None = None,
    initial: str = "random",
    precision=None,
) -> SingleDetTrial:
    """Self-consistent UHF trial for the Hubbard model.

    Mean-field decoupling H^s = T + U_eff diag(<n_{-s}>), solved with density
    mixing and random restarts. Reference: ``uhf.py:105-245``
    (find_uhf_wfn / diagonalise_mean_field / mix_density); defaults match
    ``uhf.py:62-73``.
    """
    prec = config.get_precision(precision)
    rng = np.random.default_rng(seed)
    t0 = np.asarray(ham.T[0])
    t1 = np.asarray(ham.T[1])
    m, nup, ndown = ham.nbasis, ham.nup, ham.ndown
    depsn = deps ** 0.5
    if initial == "checkerboard":
        # AF-ordered starting determinant instead of random restarts
        # (uhf.py:88-92).
        wfn = checkerboard_guess(m, nup, ndown, ham.nx, ham.ny)
        return _finalize(ham, wfn[:, :nup], wfn[:, nup:], prec, "uhf")

    def density(v):
        return np.einsum("mi,mi->m", v, v.conj()).real

    def energy(va, vb):
        g = trial_density_matrix(va.astype(np.complex128), vb.astype(np.complex128))
        ke = np.sum(t0 * g[0] + t1 * g[1])
        pe = ham.U * np.dot(np.diagonal(g[0]), np.diagonal(g[1]))
        return (ke + pe).real

    best_e, best = np.inf, None
    for _ in range(ninitial):
        # Random symmetric-matrix eigenbasis as starting orbitals
        # (uhf.py:190-194).
        ra = rng.random((m, m))
        rb = rng.random((m, m))
        _, va = _eigh_lowest(0.5 * (ra + ra.T), nup)
        _, vb = _eigh_lowest(0.5 * (rb + rb.T), ndown)
        niup, nidown = density(va), density(vb)
        niup_old, nidown_old = niup.copy(), nidown.copy()
        eold = np.inf
        for _it in range(nconv):
            _, va = _eigh_lowest(t0 + np.diag(ueff * nidown), nup)
            _, vb = _eigh_lowest(t1 + np.diag(ueff * niup), ndown)
            niup, nidown = density(va), density(vb)
            enew = energy(va, vb)
            converged = (
                abs(enew - eold) < deps
                and np.abs(niup - niup_old).sum() / m < depsn
                and np.abs(nidown - nidown_old).sum() / m < depsn
            )
            if converged:
                break
            niup_mixed = (1 - alpha) * niup + alpha * niup_old
            nidown_mixed = (1 - alpha) * nidown + alpha * nidown_old
            niup_old, nidown_old = niup, nidown
            niup, nidown = niup_mixed, nidown_mixed
            eold = enew
        if enew < best_e - deps:
            best_e, best = enew, (va, vb)

    va, vb = best
    return _finalize(ham, va, vb, prec, "uhf")
