from .diagnostics import effective_sample_size, potential_scale_reduction
from .hmc import sample_hmc
from .minimise import AdamDriver, minimise_adam, minimise_l_bfgs_b, minimise_lbfgs
from .nuts import sample_nuts
from .vars import Vars

__all__ = [
    "Vars",
    "AdamDriver",
    "minimise_adam",
    "minimise_lbfgs",
    "minimise_l_bfgs_b",
    "sample_hmc",
    "effective_sample_size",
    "potential_scale_reduction",
    "sample_nuts",
]
