"""The port's training utilities (``stheno_torch.utils``: checkpoints,
step metrics, rendering) and its optax counterparts
(``stheno_torch.opt.transform``) against ``stheno_tpu.utils`` and optax,
on the same numpy inputs, float64 on the CPU. Mirrors
``tests/utils/test_utils.py`` and adds the cross-package checkpoint
files, ``indented_kv``'s rendering, the transformations step for step
against optax and their states' key paths.

Tolerances: a checkpoint moves bits, so round trips are exact; Adam and
SGD are the same arithmetic as optax's on the same gradients, so 30 steps
agree to rtol 1e-12.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._pytree import keystr, tree_flatten_with_path

import stheno_tpu as sj
import stheno_torch as st
from stheno_tpu import utils as ju
from stheno_tpu.opt import Vars as JVars
from stheno_torch import utils as tu
from stheno_torch.opt import Vars
from stheno_torch.opt import transform as T
from tests.test_torch_helpers import np_, torch_cpu  # noqa: F401


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


# -- tests/utils/test_utils.py ------------------------------------------------


def test_pytree_roundtrip(tmp_path):
    tree = {"a": torch.arange(3.0, dtype=torch.float64),
            "b": (torch.ones(2, 2, dtype=torch.float64), torch.tensor(5))}
    path = str(tmp_path / "ckpt.npz")
    tu.save_pytree(path, tree)
    like = {"a": torch.zeros(3), "b": (torch.zeros(2, 2), torch.tensor(0))}
    out = tu.load_pytree(path, like)
    np.testing.assert_allclose(np_(out["a"]), [0, 1, 2])
    np.testing.assert_allclose(np_(out["b"][0]), 1.0)
    assert int(out["b"][1]) == 5
    with pytest.raises(ValueError):
        tu.load_pytree(path, {"only": torch.zeros(1)})


def test_vars_roundtrip(tmp_path):
    vs = Vars(device="cpu")
    vs.positive(2.5, name="ell")
    vs.unbounded(-1.0, name="mu")
    path = str(tmp_path / "vars.npz")
    tu.save_vars(path, vs)

    vs2 = Vars(device="cpu")
    vs2.positive(1.0, name="ell")
    vs2.unbounded(0.0, name="mu")
    tu.load_vars(path, vs2)
    np.testing.assert_allclose(float(vs2["ell"]), 2.5, rtol=1e-10)
    np.testing.assert_allclose(float(vs2["mu"]), -1.0, rtol=1e-10)
    # Unknown parameter -> error.
    vs3 = Vars(device="cpu")
    vs3.positive(1.0, name="other")
    with pytest.raises(ValueError):
        tu.load_vars(path, vs3)


def test_step_metrics():
    assert tu.exact_gp_flops(1000) == ju.exact_gp_flops(1000)
    assert tu.exact_gp_flops(64, d=3, grad=False) == ju.exact_gp_flops(64, d=3, grad=False)
    m = tu.StepMetrics(flops_per_step=tu.exact_gp_flops(1000))
    rec = m.log(0, 12.5, grads={"g": torch.ones(4)})
    assert rec["objective"] == 12.5
    np.testing.assert_allclose(rec["grad_norm"], 2.0)
    assert "tflops_per_s" in rec
    assert len(m.records) == 1
    # The gradient norm over a nested tree, as the JAX package's.
    r = np.random.RandomState(0)
    g = {"a": r.randn(3), "b": (r.randn(2, 2), r.randn())}
    want = ju.StepMetrics().log(1, 1.0, grads=jax.tree.map(jnp.asarray, g))["grad_norm"]
    got = tu.StepMetrics().log(1, 1.0, grads={"a": _t(g["a"]),
                                              "b": (_t(g["b"][0]), _t(g["b"][1]))})
    np.testing.assert_allclose(got["grad_norm"], want, rtol=1e-6)


def test_step_metrics_reads_the_device_once(monkeypatch):
    # One host read for the whole tree, however many leaves it has.
    reads = []
    item = torch.Tensor.item

    def counted(self):
        reads.append(1)
        return item(self)

    monkeypatch.setattr(torch.Tensor, "item", counted)
    tu.StepMetrics().log(0, 1.0, grads=[torch.ones(3) for _ in range(7)])
    assert len(reads) == 1


def test_legacy_checkpoint_treedef_mismatch_hard_errors(tmp_path):
    tree = {"a": torch.arange(3.0), "b": torch.ones(2)}
    path = str(tmp_path / "legacy.npz")
    tu.save_pytree(path, tree)
    # Strip the key-path fingerprint: the file format before it.
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files if k != "__paths__"}
    np.savez(path, **arrays)
    out = tu.load_pytree(path, {"a": torch.zeros(3), "b": torch.zeros(2)})
    np.testing.assert_allclose(np_(out["a"]), [0, 1, 2])
    with pytest.raises(ValueError, match="predates key-path"):
        tu.load_pytree(path, {"x": torch.zeros(3), "y": torch.zeros(2)})


def test_checkpoint_write_is_atomic(tmp_path):
    path = str(tmp_path / "ck.npz")
    tu.save_pytree(path, {"a": torch.ones(2)})
    assert sorted(os.listdir(tmp_path)) == ["ck.npz"]


# -- the two packages' files ----------------------------------------------------


def _state_pair():
    r = np.random.RandomState(3)
    params = {"w": r.randn(3), "b": np.asarray(0.7)}
    jstate = {"params": {k: jnp.asarray(v) for k, v in params.items()},
              "opt_state": optax.adam(0.1).init({k: jnp.asarray(v) for k, v in params.items()}),
              "step": jnp.asarray(4, jnp.int32)}
    tparams = {k: _t(v) for k, v in params.items()}
    tstate = {"params": tparams, "opt_state": T.adam(0.1).init(tparams),
              "step": torch.tensor(4, dtype=torch.int32)}
    return jstate, tstate


def test_key_paths_equal_the_jax_packages():
    jstate, tstate = _state_pair()
    want = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jstate)[0]]
    from stheno_torch.utils.checkpoint import _tree_paths

    assert _tree_paths(tstate) == want
    # Adam's state alone, for a dict, a tuple and a namedtuple of params.
    from collections import namedtuple

    P = namedtuple("P", ["u", "v"])
    for pj, pt in (({"w": jnp.zeros(2)}, {"w": torch.zeros(2)}),
                   ((jnp.zeros(2), jnp.zeros(())), (torch.zeros(2), torch.zeros(()))),
                   (P(jnp.zeros(2), jnp.zeros(())), P(torch.zeros(2), torch.zeros(())))):
        sj_ = optax.adam(0.1).init(pj)
        st_ = T.adam(0.1).init(pt)
        assert ([keystr(p) for p, _ in tree_flatten_with_path(st_)[0]]
                == [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(sj_)[0]])
        assert st_[0].count.dtype == torch.int32


def test_a_jax_checkpoint_loads_in_the_port_and_back(tmp_path):
    jstate, tstate = _state_pair()
    jstate["opt_state"] = optax.adam(0.1).update(
        jax.tree.map(jnp.ones_like, jstate["params"]), jstate["opt_state"])[1]
    path = str(tmp_path / "jax.npz")
    ju.save_pytree(path, jstate)
    # The reprs differ between the packages; the key paths agree: a warning.
    with pytest.warns(UserWarning, match="repr"):
        out = tu.load_pytree(path, tstate)
    with pytest.raises(ValueError, match="repr"):
        tu.load_pytree(path, tstate, strict=True)
    assert out["step"].dtype == torch.int32 and int(out["step"]) == 4
    assert int(out["opt_state"][0].count) == 1
    for k in ("w", "b"):
        np.testing.assert_array_equal(np_(out["opt_state"][0].mu[k]),
                                      np.asarray(jstate["opt_state"][0].mu[k]))
        np.testing.assert_array_equal(np_(out["params"][k]), np.asarray(jstate["params"][k]))
    # And the port's file loads in the JAX package.
    back = str(tmp_path / "port.npz")
    tu.save_pytree(back, out)
    with pytest.warns(UserWarning, match="repr"):
        again = ju.load_pytree(back, jstate)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_jax_vars_load_into_the_port(tmp_path):
    jv = JVars()
    jv.positive(2.5, name="ell")
    jv.unbounded(-1.0, name="mu")
    path = str(tmp_path / "vars.npz")
    ju.save_vars(path, jv)
    vs = Vars(device="cpu")
    vs.positive(1.0, name="ell")
    vs.unbounded(0.0, name="mu")
    tu.load_vars(path, vs)
    for k in ("ell", "mu"):
        np.testing.assert_array_equal(np_(vs.latent_dict()[k]), np.asarray(jv.latent_dict()[k]))


# -- rendering --------------------------------------------------------------------


def _structure(s):
    """Each line's indent and key (``None`` for a continuation line)."""
    out = []
    for line in s.split("\n"):
        m = re.match(r"^( *)(\w+)=", line)
        out.append((len(m.group(1)), m.group(2)) if m else (None, None))
    return out


def _render_pairs():
    m, v = np.zeros((2, 1)), np.eye(2)
    x = np.linspace(0, 1, 3)
    return [
        (sj.Normal(jnp.asarray(m), jnp.asarray(v)), st.Normal(_t(m), _t(v))),
        (sj.Normal(jnp.asarray(m), sj.Dense(jnp.asarray(v))), st.Normal(_t(m), st.Dense(_t(v)))),
        (sj.GP(sj.EQ())(jnp.asarray(x), 0.1), st.GP(st.EQ())(_t(x), 0.1)),
        (sj.GP(1.0, sj.EQ().stretch(2.0))(jnp.asarray(x)), st.GP(1.0, st.EQ().stretch(2.0))(_t(x))),
    ]


@pytest.mark.parametrize("fmt", [str, repr])
@pytest.mark.parametrize("case", range(4))
def test_rendering_has_the_jax_packages_line_structure(case, fmt):
    jobj, tobj = _render_pairs()[case]
    got, want = fmt(tobj), fmt(jobj)
    assert got.split("\n")[0] == want.split("\n")[0]
    assert _structure(got) == _structure(want)
    assert got.endswith(">") and want.endswith(">")


def test_indented_kv_matches_the_jax_package():
    from stheno_tpu.utils.display import indented_kv as jkv
    from stheno_torch.utils.display import indented_kv as tkv

    for key, value, kw in (("k", "a\nb", {"suffix": ","}), ("mean", "x\ny\nz", {"indent": 2}),
                           ("v", "one", {})):
        assert tkv(key, value, **kw) == jkv(key, value, **kw)


# -- the transformations against optax ----------------------------------------------


def _leaves(tree):
    from stheno_torch.utils.checkpoint import _canonical

    return torch.utils._pytree.tree_leaves(_canonical(tree))


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_transformations_match_optax(name):
    r = np.random.RandomState(5)
    init = {"w": r.randn(3), "b": (r.randn(2, 2), np.asarray(r.randn()))}
    oj = getattr(optax, name)(0.05)
    ot = getattr(T, name)(0.05)
    pj = jax.tree.map(jnp.asarray, init)
    pt = {"w": _t(init["w"]), "b": (_t(init["b"][0]), _t(init["b"][1]))}
    sj_, st_ = oj.init(pj), ot.init(pt)
    for _ in range(30):
        g = {"w": r.randn(3), "b": (r.randn(2, 2), np.asarray(r.randn()))}
        uj, sj_ = oj.update(jax.tree.map(jnp.asarray, g), sj_, pj)
        pj = optax.apply_updates(pj, uj)
        before = [t.clone() for t in _leaves(st_)]
        ut, st_new = ot.update({"w": _t(g["w"]), "b": (_t(g["b"][0]), _t(g["b"][1]))}, st_, pt)
        # Functional: the state passed in is left as it was.
        assert all(torch.equal(a, b) for a, b in zip(before, _leaves(st_)))
        st_ = st_new
        pt = T.apply_updates(pt, ut)
    for a, b in zip(jax.tree.leaves(pj), _leaves(pt), strict=True):
        np.testing.assert_allclose(np_(b), np.asarray(a), rtol=1e-12)
    for a, b in zip(jax.tree.leaves(sj_), _leaves(st_), strict=True):
        np.testing.assert_allclose(np_(b), np.asarray(a), rtol=1e-12)


def test_adam_keeps_the_dtype_and_count():
    p = {"w": torch.zeros(3, dtype=torch.float32)}
    opt = T.adam(0.1)
    s = opt.init(p)
    u, s = opt.update({"w": torch.ones(3)}, s, p)
    assert u["w"].dtype == torch.float32 and s[0].count.dtype == torch.int32
    assert int(s[0].count) == 1 and isinstance(s[1], T.EmptyState)
    np.testing.assert_allclose(np_(T.apply_updates(p, u)["w"]), -0.1, rtol=1e-6)


# -- tracing --------------------------------------------------------------------------


def test_trace_writes_a_chrome_trace(tmp_path):
    with tu.trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "prof" / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_utils_exports_match_the_jax_package():
    # collective_traffic included: it came with the distributed paths.
    assert set(tu.__all__) == set(ju.__all__)
