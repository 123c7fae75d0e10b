from .fdd import FDD, noise_as_matrix, take
from .gp import GP, assert_same_measure, intersection_measure_group
from .measure import Measure
from .observations import AbstractObservations, Obs, Observations

__all__ = [
    "FDD",
    "noise_as_matrix",
    "take",
    "GP",
    "assert_same_measure",
    "intersection_measure_group",
    "Measure",
    "AbstractObservations",
    "Observations",
    "Obs",
]
