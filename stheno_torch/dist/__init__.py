from .normal import Normal, Random, RandomProcess, RandomVector
from .rng import global_generator, set_global_seed

__all__ = [
    "Normal",
    "Random",
    "RandomProcess",
    "RandomVector",
    "global_generator",
    "set_global_seed",
]
