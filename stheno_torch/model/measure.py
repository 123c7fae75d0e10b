"""The ``Measure``: a joint Gaussian measure over a growing set of processes.

Counterpart of ``stheno_tpu/model/measure.py``: the process registry
with lazily built mean and cross-kernel tables, sums and products (GP x
GP by moment matching), the input transforms (shift, stretch, select,
transform) and derivatives of processes, the cross process, projection,
exact and pseudo-point conditioning, joint sampling, and the joint
``logpdf`` (over one pair or several, and the ELBO of
pseudo-observations). ``sample`` takes a ``torch.Generator`` where the
JAX package takes a key.
"""

import numbers

import torch

from ..dist import Random
from ..kernels import TensorProductKernel, ZeroKernel
from ..kernels.kernel import Kernel, _SwappedKernel
from ..kernels.mean import Mean
from ..lazy import LazyMatrix, LazyVector
from ..mo import AmbiguousDimensionalityKernel as ADK
from ..mo import MultiOutputKernel as MOK
from ..mo import MultiOutputMean as MOM
from ..mo import num_elements
from .fdd import FDD
from .gp import GP, assert_same_measure
from .observations import (
    AbstractObservations,
    AbstractPseudoObservations,
    Observations,
    combine,
)

__all__ = ["Measure"]


def _transpose_kernel(k):
    """``k`` with its arguments swapped: the default right rule."""
    return _SwappedKernel(k)


class Measure:
    """A GP model: processes plus lazy mean vector and kernel matrix."""

    default = None

    def __init__(self):
        self.ps = []
        self._pids = set()
        self.means = LazyVector()
        self.kernels = LazyMatrix()
        self._gps_by_name = {}
        self._names_by_gp = {}
        self._prev_default = None

    def __enter__(self):
        self._prev_default = Measure.default
        Measure.default = self
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        Measure.default = self._prev_default

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    # -- naming -----------------------------------------------------------

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._gps_by_name[key]
        return self._names_by_gp[id(key)]

    def name(self, p, name):
        """Assign a unique name to a process."""
        if id(p) in self._names_by_gp:
            del self._gps_by_name[self._names_by_gp[id(p)]]
            del self._names_by_gp[id(p)]
        if name in self._gps_by_name:
            raise RuntimeError(f'Name "{name}" for "{p}" already taken by "{self[name]}".')
        self._gps_by_name[name] = p
        self._names_by_gp[id(p)] = name

    # -- graph update -----------------------------------------------------

    def _add_p(self, p):
        self.ps.append(p)
        self._pids.add(id(p))
        p._measures.append(self)

    def _update(self, p, mean, kernel, left_rule, right_rule=None):
        self.means[p] = mean
        self.kernels[p] = kernel
        self.kernels.add_left_rule(id(p), self._pids, left_rule)
        if right_rule is None:
            right_rule = lambda i: _transpose_kernel(self.kernels[p, i])  # noqa: E731
        self.kernels.add_right_rule(id(p), self._pids, right_rule)
        # Add `p` only now: the rules above capture the pid set without `p`.
        self._add_p(p)
        return p

    def add_gp(self, mean, kernel, left_rule, right_rule=None):
        """Add a hand-rolled process with explicit cross-kernel rules."""
        return self._update(GP(), mean, kernel, left_rule, right_rule)

    def add_independent_gp(self, p, mean, kernel):
        """Register ``p`` as independent of everything already in the measure."""
        self.means[p] = mean
        self.kernels[p] = kernel
        self.kernels.add_left_rule(id(p), self._pids, lambda j: ZeroKernel())
        self.kernels.add_right_rule(id(p), self._pids, lambda i: ZeroKernel())
        self._add_p(p)
        return p

    def __call__(self, obj):
        """Project a GP or FDD into this measure."""
        if isinstance(obj, FDD):
            return self(obj.p)(obj.x, obj.noise)
        p = obj
        return self._update(
            GP(),
            self.means[p],
            self.kernels[p],
            lambda j: self.kernels[p, j],
            lambda i: self.kernels[i, p],
        )

    # -- algebra ----------------------------------------------------------

    def sum(self, p_sum, obj1, obj2):
        """``p_sum = obj1 + obj2`` where at least one is a GP of this measure."""
        if isinstance(obj1, GP) and isinstance(obj2, GP):
            assert_same_measure(obj1, obj2)
            p1, p2 = obj1, obj2
            return self._update(
                p_sum,
                self.means[p1] + self.means[p2],
                self.kernels[p1] + self.kernels[p2] + self.kernels[p1, p2] + self.kernels[p2, p1],
                lambda j: self.kernels[p1, j] + self.kernels[p2, j],
            )
        if not isinstance(obj1, GP):
            obj1, obj2 = obj2, obj1
        p, other = obj1, obj2
        if isinstance(other, Random):
            raise TypeError(f"Cannot add a GP and a {type(other).__name__}.")
        return self._update(
            p_sum, self.means[p] + other, self.kernels[p], lambda j: self.kernels[p, j]
        )

    def mul(self, p_mul, obj1, obj2):
        """``p_mul = obj1 * obj2``; GP x GP by moment matching."""
        if isinstance(obj1, GP) and isinstance(obj2, GP):
            assert_same_measure(obj1, obj2)
            p1, p2 = obj1, obj2
            term1 = self.sum(
                GP(),
                self.mul(GP(), _mean_fn(self, p1), p2),
                self.mul(GP(), p1, _mean_fn(self, p2)),
            )
            term2 = self.add_independent_gp(
                GP(),
                -self.means[p1] * self.means[p2],
                self.kernels[p1] * self.kernels[p2] + self.kernels[p1, p2] * self.kernels[p2, p1],
            )
            return self.sum(p_mul, term1, term2)
        if not isinstance(obj1, GP):
            obj1, obj2 = obj2, obj1
        p, other = obj1, obj2
        if isinstance(other, Random):
            raise TypeError(f"Cannot multiply a GP and a {type(other).__name__}.")
        if callable(other) and not isinstance(other, (Kernel, Mean)):
            f = other
            return self._update(
                p_mul,
                f * self.means[p],
                f * self.kernels[p],
                lambda j: TensorProductKernel(f, _one_fn) * self.kernels[p, j],
            )
        return self._update(
            p_mul,
            self.means[p] * other,
            self.kernels[p] * other**2,
            lambda j: self.kernels[p, j] * other,
        )

    def shift(self, p_shifted, p, shift):
        """``p_shifted(x) = p(x - shift)``."""
        return self._update(
            p_shifted,
            self.means[p].shift(shift),
            self.kernels[p].shift(shift),
            lambda j: self.kernels[p, j].shift(shift, 0),
        )

    def stretch(self, p_stretched, p, stretch):
        """``p_stretched(x) = p(x / stretch)``."""
        return self._update(
            p_stretched,
            self.means[p].stretch(stretch),
            self.kernels[p].stretch(stretch),
            lambda j: self.kernels[p, j].stretch(stretch, 1),
        )

    def select(self, p_selected, p, *dims):
        """``p_selected(x) = p(x[:, dims])``."""
        return self._update(
            p_selected,
            self.means[p].select(dims),
            self.kernels[p].select(dims),
            lambda j: self.kernels[p, j].select(dims, None),
        )

    def transform(self, p_transformed, p, f):
        """``p_transformed(x) = p(f(x))``."""
        return self._update(
            p_transformed,
            self.means[p].transform(f),
            self.kernels[p].transform(f),
            lambda j: self.kernels[p, j].transform(f, None),
        )

    def diff(self, p_diff, p, dim=0):
        """``p_diff`` is the derivative of ``p`` in input dimension ``dim``."""
        return self._update(
            p_diff,
            self.means[p].diff(dim),
            self.kernels[p].diff(dim),
            lambda j: self.kernels[p, j].diff(dim, None),
        )

    def cross(self, p_cross, *ps):
        """Cartesian product process."""
        mok = MOK(self, *ps)
        return self._update(
            p_cross,
            MOM(self, *ps),
            mok,
            # The cross rule turns inputs into FDD tags, which hides the
            # dimensionality: wrap in ADK.
            lambda j: ADK(mok.transform(None, lambda y: FDD(j, y))),
        )

    # -- conditioning -----------------------------------------------------

    def condition(self, *args):
        """Condition on observations, returning the posterior measure."""
        if len(args) == 1 and isinstance(args[0], AbstractObservations):
            obs = args[0]
        else:
            obs = Observations(*args)
        posterior = Measure()
        posterior.ps = list(self.ps)
        posterior._pids = set(self._pids)
        posterior.means.add_rule(posterior._pids, lambda i: obs.posterior_mean(self, i))
        posterior.kernels.add_rule(
            posterior._pids, lambda i, j: obs.posterior_kernel(self, i, j)
        )
        for p in posterior.ps:
            p._measures.append(posterior)
        return posterior

    def __or__(self, args):
        if isinstance(args, tuple):
            return self.condition(*args)
        return self.condition(args)

    # -- sampling ---------------------------------------------------------

    def sample(self, *args):
        """Sample processes jointly: ``m.sample([generator,] [n,] *fdds)``.

        Draws from ``generator`` (a ``torch.Generator``), or from the global
        generator (``stheno_torch.dist.rng``) when none is given. Returns
        the sample of each FDD, ``(num_elements, n)``, as a tuple, or the
        one sample for one FDD."""
        generator = None
        if args and isinstance(args[0], torch.Generator):
            generator, args = args[0], args[1:]
        n = 1
        if args and isinstance(args[0], numbers.Integral):
            n, args = int(args[0]), args[1:]
        fdds = args
        if not fdds or not all(isinstance(f, FDD) for f in fdds):
            raise ValueError("Give FDDs to sample.")
        # Sample under this measure.
        sample = self(combine(*fdds)).sample(generator, n)
        i, samples = 0, []
        for fdd in fdds:
            length = num_elements(fdd)
            samples.append(sample[..., i:i + length, :])
            i += length
        return samples[0] if len(samples) == 1 else tuple(samples)

    # -- densities --------------------------------------------------------

    def logpdf(self, *args):
        """Joint log-density of observation pairs; for pseudo-observations
        this is the ELBO."""
        if len(args) == 1 and isinstance(args[0], AbstractPseudoObservations):
            return args[0].elbo(self)
        if len(args) == 1 and isinstance(args[0], Observations):
            return self.logpdf(args[0].fdd, args[0].y)
        if len(args) == 2 and isinstance(args[0], FDD):
            fdd, y = args
        elif all(isinstance(a, (tuple, list)) for a in args):
            fdd, y = combine(*[tuple(a) for a in args])
        else:
            raise ValueError("Give (fdd, y) or pairs of observations.")
        return self(fdd).logpdf(y)


def _mean_fn(measure, p):
    """The mean of ``p`` as a plain function (for the moment-matching
    product)."""
    mean = measure.means[p]

    def f(x):
        from ..kernels import mean_eval

        return mean_eval(mean, x)

    return f


def _one_fn(x):
    shape = x.shape[:-1] if x.ndim >= 2 else x.shape
    return x.new_ones(shape + (1,))
