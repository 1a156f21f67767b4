"""Trial wavefunction file I/O.

Reads either this package's own simple layout (arrays ``psi`` (+optional
``coeffs``), in HDF5 or a numpy ``.npz``) or the QMCPACK NOMSD HDF5 group
the reference writes (``pauxy/utils/io.py:325-460``). Only the HDF5 forms
need h5py.
"""

from __future__ import annotations

import numpy as np

from pauxy_jax.utils.io import _h5py


def read_orbitals(filename: str):
    """Return (psi [ndet, M, na+nb] or [M, na+nb], coeffs or None)."""
    if filename.endswith(".npz"):
        with np.load(filename) as f:
            return f["psi"], (f["coeffs"] if "coeffs" in f.files else None)
    with _h5py().File(filename, "r") as fh5:
        if "psi" in fh5:
            psi = fh5["psi"][:]
            coeffs = fh5["coeffs"][:] if "coeffs" in fh5 else None
            return psi, coeffs
        if "Wavefunction" in fh5:
            # Reference NOMSD layout (io.py:407-460): PsiT_{i}/<spin parts>.
            grp = fh5["Wavefunction/NOMSD"]
            coeffs = grp["ci_coeffs"][:].view(np.complex128).ravel()
            psis = []
            dets = sorted(
                (k for k in grp.keys() if k.startswith("PsiT_")),
                key=lambda k: int(k.split("_")[1]),
            )
            for k in dets:
                sub = grp[k]
                mats = []
                for part in sorted(sub.keys()):
                    data = sub[part][:]
                    if data.ndim == 3 and data.shape[-1] == 2:
                        data = data.view(np.complex128)[..., 0]
                    mats.append(data)
                psis.append(np.concatenate(mats, axis=1))
            return np.array(psis), coeffs
    raise ValueError(f"unrecognized wavefunction file {filename!r}")


def read_wavefunction(ham, filename: str, precision=None):
    from pauxy_jax.models.trial import trial_from_orbitals

    psi, coeffs = read_orbitals(filename)
    if psi.ndim == 3:
        if psi.shape[0] > 1:
            from pauxy_jax.models.multi_slater import multi_slater_trial

            return multi_slater_trial(ham, psi, coeffs, precision=precision)
        psi = psi[0]
    return trial_from_orbitals(ham, psi, precision=precision, name="file")


def write_wavefunction(psi: np.ndarray, filename: str, coeffs=None):
    with _h5py().File(filename, "w") as fh5:
        fh5["psi"] = np.asarray(psi)
        if coeffs is not None:
            fh5["coeffs"] = np.asarray(coeffs)


def write_qmcpack_wfn(filename: str, coeffs: np.ndarray, wfn: np.ndarray,
                      nelec, mode: str = "w"):
    """Write a NOMSD trial in the QMCPACK HDF5 group layout this module's
    :func:`read_orbitals` parses (counterpart of the reference's
    ``write_qmcpack_wfn``, ``pauxy/utils/io.py:407-460``; determinant
    blocks are stored dense rather than CSR — a deliberate simplification,
    the reader accepts both shapes).

    coeffs [D] complex; wfn [D, M, na+nb]; nelec (na, nb).
    """
    na, nb = nelec
    coeffs = np.asarray(coeffs, dtype=np.complex128)
    wfn = np.asarray(wfn, dtype=np.complex128)

    def ri(x):
        return np.stack([x.real, x.imag], axis=-1)

    with _h5py().File(filename, mode) as fh5:
        if "Wavefunction" in fh5:
            del fh5["Wavefunction"]
        grp = fh5.create_group("Wavefunction/NOMSD")
        grp["ci_coeffs"] = ri(coeffs)
        grp["dims"] = np.array([wfn.shape[1], na, nb, len(coeffs)])
        for i, det in enumerate(wfn):
            sub = grp.create_group(f"PsiT_{i}")
            sub["alpha"] = ri(det[:, :na])
            sub["beta"] = ri(det[:, na:])
