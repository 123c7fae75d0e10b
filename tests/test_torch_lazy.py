"""The lazy rule tables of ``tests/test_lazy.py`` on the port
(``stheno_torch/lazy.py``): resolution order, identity indexing, frozen
rule index sets, memoisation."""

import pytest

from stheno_torch import LazyMatrix, LazyVector


class Box:
    pass


def test_lazy_vector():
    v = LazyVector()
    a, b = Box(), Box()
    v[a] = 1
    assert v[a] == 1
    v.add_rule({id(b)}, lambda i: 42)
    assert v[b] == 42
    with pytest.raises(RuntimeError):
        v[Box()]


def test_rules_freeze_index_set():
    v = LazyVector()
    a = Box()
    indices = {id(a)}
    v.add_rule(indices, lambda i: "old")
    b = Box()
    indices.add(id(b))  # Mutating the set must not extend the rule.
    with pytest.raises(RuntimeError):
        v[b]
    assert v[a] == "old"


def test_lazy_matrix_resolution_order():
    m = LazyMatrix()
    a, b = Box(), Box()
    # A universal rule wins over left and right rules.
    m.add_left_rule(id(a), {id(a), id(b)}, lambda j: "left")
    m.add_rule({id(a)}, lambda i, j: "universal")
    assert m[a, a] == "universal"
    assert m[a, b] == "left"
    # Right rules resolve after left rules.
    m.add_right_rule(id(a), {id(b)}, lambda i: "right")
    assert m[b, a] == "right"
    assert m[a] == m[a, a]  # The diagonal shorthand.


def test_lazy_matrix_memoization():
    m = LazyMatrix()
    a = Box()
    calls = []
    m.add_rule({id(a)}, lambda i, j: calls.append(1) or object())
    assert m[a, a] is m[a, a]
    assert len(calls) == 1


def test_explicit_set():
    m = LazyMatrix()
    a, b = Box(), Box()
    m[a, b] = "ab"
    assert m[a, b] == "ab"
    with pytest.raises(RuntimeError):
        m[b, a]
