from .fdd import FDD, noise_as_matrix, take
from .gp import GP, assert_same_measure, cross, intersection_measure_group
from .measure import Measure
from .pathwise import pathwise_sampler
from .svgp import svgp_elbo, svgp_init, svgp_natgrad_step, svgp_predict
from .observations import (
    AbstractObservations,
    AbstractPseudoObservations,
    Obs,
    Observations,
    PseudoObs,
    PseudoObsDTC,
    PseudoObservations,
    PseudoObservationsDTC,
    PseudoObservationsFITC,
    PseudoObsFITC,
    SparseObs,
    SparseObservations,
    combine,
)

__all__ = [
    "FDD",
    "noise_as_matrix",
    "take",
    "GP",
    "cross",
    "assert_same_measure",
    "intersection_measure_group",
    "Measure",
    "pathwise_sampler",
    "svgp_init",
    "svgp_elbo",
    "svgp_predict",
    "svgp_natgrad_step",
    "combine",
    "AbstractObservations",
    "Observations",
    "Obs",
    "AbstractPseudoObservations",
    "PseudoObservations",
    "PseudoObs",
    "PseudoObservationsFITC",
    "PseudoObsFITC",
    "PseudoObservationsDTC",
    "PseudoObsDTC",
    "SparseObs",
    "SparseObservations",
]
