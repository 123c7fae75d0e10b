"""Checkpoint and resume for hyperparameter and optimiser state.

Counterpart of ``stheno_tpu/utils/checkpoint.py``, in the same container:
any pytree of tensors (a ``Vars`` latent dict, an optimiser state, a
training state) is written to one numpy npz file, its leaves as
``leaf_0``, ``leaf_1``, ... and its structure beside them: ``__treedef__``
(the structure's repr) and ``__paths__`` (the key path of every leaf).

Leaves are ordered as the JAX package orders them, dicts by sorted key,
and the key paths are spelled as ``jax.tree_util.keystr`` spells them
(``torch.utils._pytree.keystr`` gives the same strings for dicts, tuples
and namedtuples). So a file written by either package loads in the other:
the leaves and paths agree, and only the repr differs, which warns."""

import json
import os
import warnings

import numpy as np
import torch
from torch.utils._pytree import keystr, tree_flatten, tree_flatten_with_path

from .. import config

__all__ = ["save_pytree", "load_pytree", "save_vars", "load_vars"]


def _canonical(tree):
    """``tree`` with every dict rebuilt in sorted key order, the order in
    which the JAX package flattens a dict."""
    if isinstance(tree, dict):
        return {k: _canonical(tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_canonical(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_canonical(v) for v in tree)
    return tree


def _tree_paths(tree):
    """The key path of every leaf: names the slots (dict keys, namedtuple
    fields, positions), which a change of the structure's repr across
    versions does not change."""
    return [keystr(p) for p, _ in tree_flatten_with_path(_canonical(tree))[0]]


def _to_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _write_npz(path, arrays):
    # Write then rename: a crash mid-write leaves the previous file whole.
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path)


def save_pytree(path, tree):
    """Serialise a pytree of tensors to ``path`` (npz, with its structure)."""
    tree = _canonical(tree)
    leaves, spec = tree_flatten(tree)
    arrays = {f"leaf_{i}": _to_numpy(l) for i, l in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(json.dumps(str(spec)).encode(), dtype=np.uint8)
    arrays["__paths__"] = np.frombuffer(json.dumps(_tree_paths(tree)).encode(), dtype=np.uint8)
    _write_npz(path, arrays)


def load_pytree(path, like, *, strict=False):
    """Load the leaves saved by :func:`save_pytree` into the structure of
    ``like`` (a template pytree). Each leaf goes to the device of the
    template's leaf in its slot, in the dtype it was stored in.

    Structural guards, hard to soft:

    - a leaf count mismatch raises;
    - a key-path mismatch (dict keys, field names, positions) raises: the
      same leaf count in a different structure;
    - a repr mismatch with the same key paths only warns (reprs differ
      between versions and between the two packages); ``strict=True``
      raises there too. A file without key paths has only its repr to go
      by, so there a repr mismatch raises."""
    with np.load(path) as data:
        n = len([k for k in data.files if k.startswith("leaf_")])
        stored = [data[f"leaf_{i}"] for i in range(n)]
        stored_treedef = None
        if "__treedef__" in data.files:
            stored_treedef = json.loads(bytes(data["__treedef__"]).decode())
        stored_paths = None
        if "__paths__" in data.files:
            stored_paths = json.loads(bytes(data["__paths__"]).decode())
    like = _canonical(like)
    template, spec = tree_flatten(like)
    if len(template) != len(stored):
        raise ValueError(f"Checkpoint has {len(stored)} leaves; template has {len(template)}.")
    if stored_paths is not None and stored_paths != _tree_paths(like):
        raise ValueError(
            "Checkpoint pytree structure does not match the template "
            "(same leaf count, different leaf key paths: e.g. a "
            "different optimizer/state layout).\n"
            f"  stored:   {stored_paths}\n"
            f"  template: {_tree_paths(like)}"
        )
    if stored_treedef is not None and stored_treedef != str(spec):
        if stored_paths is None:
            # Without key paths the repr is the only evidence that the
            # structures match: loading anyway could put leaves in the
            # wrong slots of a resumed run.
            raise ValueError(
                "Checkpoint treedef repr does not match the template and "
                "the checkpoint predates key-path fingerprints, so the "
                "structures cannot be confirmed compatible.\n"
                f"  stored:   {stored_treedef}\n  template: {spec}"
            )
        msg = (
            "Checkpoint treedef repr does not match the template, but the "
            "leaf key paths do (a version change, or a file of the other "
            "package). Loading anyway.\n"
            f"  stored:   {stored_treedef}\n  template: {spec}"
        )
        if strict:
            raise ValueError(msg)
        warnings.warn(msg, stacklevel=2)
    leaves = [
        torch.as_tensor(a, device=t.device if isinstance(t, torch.Tensor) else config.resolve_device())
        for a, t in zip(stored, template)
    ]
    return spec.unflatten(leaves)


def save_vars(path, vs):
    """Persist a :class:`stheno_torch.opt.Vars` container's latent state."""
    latent = vs.latent_dict()
    _write_npz(path, {f"var_{n}": _to_numpy(latent[n]) for n in sorted(latent)})


def load_vars(path, vs):
    """Restore latent values into ``vs``, in its dtype and on its device
    (the parameters must already be registered, e.g. by calling the model
    function once)."""
    with np.load(path) as data:
        latent = {
            k[len("var_"):]: torch.as_tensor(data[k], dtype=vs.dtype, device=vs.device)
            for k in data.files
            if k.startswith("var_")
        }
    unknown = set(latent) - set(vs.latent_dict())
    if unknown:
        raise ValueError(f"Checkpoint contains unknown parameters {unknown}.")
    vs.assign_latent(latent)
    return vs
