"""Identity-indexed lazy tables for measure means and cross-kernels.

Counterpart of ``stheno_tpu/lazy.py`` (pure Python, copied whole).
Semantics match the reference's ``stheno/lazy.py`` (rule resolution order
universal -> left -> right; rules capture a *frozen* index set so processes
added later don't match older rules; diagonal shorthand ``m[p] == m[p, p]``;
missing index -> RuntimeError). Implementation is our own: a flat dict keyed
by integer ids with explicit rule lists."""

__all__ = ["LazyVector", "LazyMatrix"]


def _resolve(key):
    """Resolve a key to a hashable index: ints pass through, objects use
    their identity."""
    if isinstance(key, int):
        return key
    return id(key)


class LazyVector:
    """Lazily-built vector indexed by object identity."""

    def __init__(self):
        self._store = {}
        self._rules = []

    def __setitem__(self, key, value):
        self._store[_resolve(key)] = value

    def __getitem__(self, key):
        i = _resolve(key)
        if i in self._store:
            return self._store[i]
        for indices, make in self._rules:
            if i in indices:
                value = make(i)
                self._store[i] = value
                return value
        raise RuntimeError(f'Could not build value for index "{i}".')

    def add_rule(self, indices, make):
        """Add a rule over a frozen copy of ``indices``; ``make(i)`` builds
        the element for index ``i``."""
        self._rules.append((frozenset(indices), make))


class LazyMatrix:
    """Lazily-built matrix indexed by pairs of object identities."""

    def __init__(self):
        self._store = {}
        self._rules = []
        self._left_rules = []
        self._right_rules = []

    def _expand(self, key):
        if isinstance(key, tuple):
            i, j = key
            return _resolve(i), _resolve(j)
        i = _resolve(key)
        return i, i

    def __setitem__(self, key, value):
        self._store[self._expand(key)] = value

    def __getitem__(self, key):
        ij = self._expand(key)
        if ij in self._store:
            return self._store[ij]
        value = self._build(*ij)
        self._store[ij] = value
        return value

    def _build(self, i, j):
        for indices, make in self._rules:
            if i in indices and j in indices:
                return make(i, j)
        for i_fixed, indices, make in self._left_rules:
            if i == i_fixed and j in indices:
                return make(j)
        for j_fixed, indices, make in self._right_rules:
            if i in indices and j == j_fixed:
                return make(i)
        raise RuntimeError(f"Could not build value for index {(i, j)}.")

    def add_rule(self, indices, make):
        """Universal rule: ``make(i, j)`` for ``i, j`` both in the frozen
        copy of ``indices``."""
        self._rules.append((frozenset(indices), make))

    def add_left_rule(self, i_left, indices, make):
        """Rule for a fixed left index: ``make(j)`` for ``j`` in the
        frozen copy of ``indices``."""
        self._left_rules.append((i_left, frozenset(indices), make))

    def add_right_rule(self, i_right, indices, make):
        """Rule for a fixed right index: ``make(i)``."""
        self._right_rules.append((i_right, frozenset(indices), make))
