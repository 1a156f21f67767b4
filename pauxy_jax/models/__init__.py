"""Model Hamiltonians and trial wavefunctions.

Each system is a frozen pytree dataclass holding device arrays (hopping /
integral tensors) plus static metadata (particle numbers, basis size). They
are constructed host-side with numpy and passed *as arguments* into jitted
step functions — never baked in as constants.
"""

from pauxy_jax.models.hubbard import Hubbard, make_hubbard
from pauxy_jax.models.generic import Generic, make_generic
from pauxy_jax.models.ueg import UEG, make_ueg
from pauxy_jax.models.pw_fft import PWFFT, make_pw_fft
from pauxy_jax.models.multi_slater import MultiSlaterTrial, multi_slater_trial
from pauxy_jax.models.trial import (
    SingleDetTrial,
    free_electron_trial,
    rhf_identity_trial,
    trial_from_orbitals,
    uhf_trial,
)

__all__ = [
    "Hubbard",
    "make_hubbard",
    "Generic",
    "make_generic",
    "UEG",
    "make_ueg",
    "PWFFT",
    "make_pw_fft",
    "MultiSlaterTrial",
    "multi_slater_trial",
    "SingleDetTrial",
    "free_electron_trial",
    "rhf_identity_trial",
    "trial_from_orbitals",
    "uhf_trial",
]
