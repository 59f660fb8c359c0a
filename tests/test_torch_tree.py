"""The port's tree handling (ray_tpu_torch.tree) against `jax.tree`, on the
CPU: leaf order and rebuilt types for plain dicts, OrderedDicts,
defaultdicts and namedtuples, nested; checkpoints of such trees written
by one package and restored by the other, both directions; and the two
other places that rebuild containers, `from_jax_adamw_state` and
`map_specs`.

`torch.nn.Module.state_dict()` returns an OrderedDict and optax's
optimizer states are namedtuples, so these are the trees a user's
checkpoint holds. Values are small integers or numpy draws, held bit for
bit.
"""
from __future__ import annotations

from collections import OrderedDict, defaultdict, namedtuple

import jax
import numpy as np
import optax
import pytest
import torch

from ray_tpu.train import async_checkpoint as jac
from ray_tpu_torch.models.convert import (from_jax_adamw_state,
                                          from_jax_params)
from ray_tpu_torch.parallel.mesh import P, map_specs
from ray_tpu_torch.train import async_checkpoint as tac
from ray_tpu_torch.tree import (tree_flatten, tree_leaves, tree_map,
                                tree_unflatten)

S = namedtuple("S", "mu nu")


def _trees():
    """Trees whose leaves are distinct ints, so a leaf order is visible
    (plain dicts inside the nested one)."""
    return {
        "ordered_dict": OrderedDict(b=1, a=2, c=3),
        "defaultdict": defaultdict(list, b=1, a=2),
        "namedtuple": S(1, 2),
        "nested": {"s": S(OrderedDict(z=1, y=[2, (3, None)]), 4),
                   "a": defaultdict(int, q=5, p=S(6, 7)),
                   "o": OrderedDict(k=None, j={"n": 8, "m": 9}), "b": 10},
    }


def _same_structure(got, want):
    """Same container types (defaultdict factories too) and keys, all the
    way down, and equal leaves."""
    assert type(got) is type(want), (type(got), type(want))
    if isinstance(want, dict):
        assert set(got) == set(want)
        if isinstance(want, defaultdict):
            assert got.default_factory is want.default_factory
        if type(want) is OrderedDict:
            assert list(got) == list(want)
        for k in want:
            _same_structure(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_structure(g, w)
    else:
        assert got == want


@pytest.mark.parametrize("name", list(_trees()))
def test_flatten_and_unflatten_match_jax(name):
    """tree_flatten's leaf order is jax.tree.flatten's (a plain dict and a
    defaultdict by sorted key, an OrderedDict in insertion order, a
    namedtuple by field, None no leaf); tree_unflatten rebuilds every
    container as its own type, as jax.tree.unflatten does; tree_map keeps
    the types too."""
    tree = _trees()[name]
    leaves, structure = tree_flatten(tree)
    jleaves, jdef = jax.tree.flatten(tree)
    assert leaves == jleaves
    back = tree_unflatten(structure, [x * 10 for x in leaves])
    jback = jax.tree.unflatten(jdef, [x * 10 for x in jleaves])
    _same_structure(back, jback)
    _same_structure(tree_map(lambda x: x * 10, tree), jback)


def test_tree_leaves_keeps_insertion_order_for_plain_dicts():
    """tree_leaves is the order TrainStep and AdamW zip gradients by:
    insertion order for a plain dict (where jax sorts), the others as
    jax."""
    assert tree_leaves({"b": 1, "a": 2}) == [1, 2]
    assert tree_leaves(OrderedDict(b=1, a=2)) == [1, 2]
    assert tree_leaves(S(1, 2)) == [1, 2]
    assert tree_leaves([None, 1, (None, 2)]) == [1, 2]


# ------------------------------------------------------------ checkpoints

def _ckpt_trees(seed):
    """ROADMAP's two inputs: an OrderedDict whose insertion order is not
    sorted, and a namedtuple beside a leaf."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"ordered_dict": OrderedDict(b=f32(2), a=f32(3, 2)),
            "namedtuple": {"s": S(f32(4), f32(2, 2)), "a": f32(1)}}


def _assert_tree_equal(got, want):
    """Same containers, and every leaf's values bit for bit."""
    def plain(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    _same_structure(tree_map(lambda x: 0, got), tree_map(lambda x: 0, want))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(plain(g), plain(w))


def _jax_read_with_template(directory, like):
    """JAX's reader with a template (restore(like=)'s path, on the
    template's treedef: the port's treedef.pkl is not a JAX treedef)."""
    manifests = jac._load_manifests(directory)
    treedef = jax.tree.structure(like)
    readers = []
    for i in range(treedef.num_leaves):
        meta = manifests[0]["leaves"][str(i)]
        readers.append(jac._LeafReader(directory, tuple(meta["shape"]),
                                       np.dtype(meta["dtype"]),
                                       meta["shards"]))
    return jac.materialize_like(readers, treedef, like)


@pytest.mark.parametrize("name", ["ordered_dict", "namedtuple"])
def test_port_restores_jax_checkpoint(tmp_path, name):
    """JAX's async_save, the port's restore(like=): the right values in
    the right places and the template's containers (JAX's own restore is
    the reference)."""
    tree = _ckpt_trees(1)[name]
    d = str(tmp_path / "ck")
    jac.async_save(d, tree).wait()
    like = tree_map(lambda x: torch.zeros(x.shape), tree)
    got = tac.restore(d, like=like)
    _assert_tree_equal(got, tree)
    _assert_tree_equal(got, jac.restore(d, like=tree))


@pytest.mark.parametrize("name", ["ordered_dict", "namedtuple"])
def test_jax_reads_port_checkpoint(tmp_path, name):
    """The port's async_save, read back by JAX's reader with a template of
    the same tree and by the port's restore, with and without one."""
    tree = _ckpt_trees(2)[name]
    d = str(tmp_path / "ck")
    tac.async_save(d, tree_map(torch.from_numpy, tree)).wait()
    _assert_tree_equal(_jax_read_with_template(
        d, tree_map(np.zeros_like, tree)), tree)
    _assert_tree_equal(tac.restore(d), tree)
    _assert_tree_equal(tac.restore(
        d, like=tree_map(lambda x: torch.zeros(x.shape), tree)), tree)


# ---------------------------------------------- other container rebuilds

def test_from_jax_adamw_state_keeps_namedtuples_and_ordered_dicts():
    """optax.adamw's moments of a tree holding a namedtuple and an
    OrderedDict come over with those containers and values."""
    rng = np.random.default_rng(3)
    params = {"s": S(rng.standard_normal(3).astype(np.float32),
                     rng.standard_normal((2, 2)).astype(np.float32)),
              "o": OrderedDict(b=rng.standard_normal(2).astype(np.float32),
                               a=rng.standard_normal(1).astype(np.float32))}
    opt = optax.adamw(1e-2)
    state = opt.init(params)
    grads = jax.tree.map(lambda x: x * 0.5 + 1.0, params)
    _, state = opt.update(grads, state, params)
    like = from_jax_params(params, device="cpu")
    _same_structure(tree_map(lambda x: 0, like),
                    tree_map(lambda x: 0, params))
    got = from_jax_adamw_state(jax.tree.map(np.asarray, state), like,
                               device="cpu")
    assert got["count"] == 1
    _assert_tree_equal(got["mu"], jax.tree.map(np.asarray, state[0].mu))
    _assert_tree_equal(got["nu"], jax.tree.map(np.asarray, state[0].nu))


def test_map_specs_keeps_namedtuples():
    """map_specs over a namedtuple, with a namedtuple of specs and with a
    spec prefix over it, returns the namedtuple."""
    tree = {"s": S(torch.zeros(4), torch.zeros(2, 2)),
            "o": OrderedDict(b=torch.zeros(1), a=torch.zeros(2))}
    specs = {"s": S(P("fsdp"), P(None, "tp")), "o": P()}
    got = map_specs(lambda spec, x, path: (spec, path), specs, tree)
    assert type(got["s"]) is S and type(got["o"]) is OrderedDict
    assert list(got["o"]) == ["b", "a"]
    assert got["s"].mu == (P("fsdp"), "['s'][0]")
    assert got["s"].nu == (P(None, "tp"), "['s'][1]")
    assert got["o"]["a"] == (P(), "['o']['a']")
    whole = map_specs(lambda spec, x, path: spec, P("dp"), tree)
    assert type(whole["s"]) is S and whole["s"].nu == P("dp")
