"""QMC run options (``pauxy/qmc/options.py:22-123`` counterpart).

Same JSON keys/aliases/defaults as the reference so input files carry over.
"""

from __future__ import annotations

import dataclasses

from pauxy_jax.utils.io import get_input_value


@dataclasses.dataclass
class QMCOpts:
    nwalkers: int = 10
    dt: float = 0.005
    nsteps: int = 10
    nblocks: int = 1000
    nstblz: int = 10
    npop_control: int = 1
    eqlb_time: float = 2.0
    beta: float | None = None
    rng_seed: int | None = None
    pop_control_method: str = "comb"
    scaled_temp: bool = False
    beta_scaled: float | None = None

    @property
    def total_steps(self) -> int:
        return self.nsteps * self.nblocks

    @property
    def neqlb(self) -> int:
        return int(self.eqlb_time / self.dt)

    def convert_from_reduced_units(self, system, verbose: bool = False):
        """theta = T/T_F reduced units -> Hartree (``options.py:5-19``):
        beta and dt are given in units of the inverse Fermi temperature."""
        tf = system.ef
        self.beta_scaled = self.beta
        self.dt = self.dt / tf
        self.beta = self.beta / tf
        if verbose:
            print(f"# beta in Hartree^-1:  {self.beta:13.8e}")
            print(f"# dt in Hartree^-1: {self.dt:13.8e}")

    @classmethod
    def from_dict(cls, inputs: dict, verbose: bool = False) -> "QMCOpts":
        return cls(
            nwalkers=get_input_value(
                inputs, "num_walkers", default=10, alias=["nwalkers"], verbose=verbose
            ),
            dt=get_input_value(
                inputs, "timestep", default=0.005, alias=["dt"], verbose=verbose
            ),
            nsteps=get_input_value(
                inputs, "num_steps", default=10, alias=["nsteps", "steps"],
                verbose=verbose,
            ),
            nblocks=get_input_value(
                inputs, "blocks", default=1000, alias=["num_blocks", "nblocks"],
                verbose=verbose,
            ),
            nstblz=get_input_value(
                inputs, "stabilise_freq", default=10,
                alias=["nstabilise", "reortho"], verbose=verbose,
            ),
            npop_control=get_input_value(
                inputs, "pop_control_freq", default=1,
                alias=["npop_control", "pop_control"], verbose=verbose,
            ),
            eqlb_time=get_input_value(
                inputs, "equilibration_time", default=2.0, alias=["tau_eqlb"],
                verbose=verbose,
            ),
            beta=get_input_value(inputs, "beta", default=None, verbose=verbose),
            rng_seed=get_input_value(
                inputs, "rng_seed", default=None, alias=["random_seed", "seed"],
                verbose=verbose,
            ),
            pop_control_method=get_input_value(
                inputs, "pop_control_method", default="comb", verbose=verbose
            ),
            scaled_temp=get_input_value(
                inputs, "scaled_temperature", default=False,
                alias=["reduced_temperature"], verbose=verbose,
            ),
        )
