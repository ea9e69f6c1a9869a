"""The port's mesh code against the reference's, with no devices.

* Every parameter leaf of the ten LM archs at full size, on the 16x16
  and 2x16x16 production meshes, gets the reference's `param_spec`.
  The rules read only the mesh's axis names and sizes, so each side
  gets a stand-in mesh with those alone.
* The batch and cache specs of every `SHAPE_GRID` cell equal the
  reference's, and so do `input_specs`' shapes and dtypes (the
  reference's from ``jax.eval_shape``); `applicable` gives the same
  answers and reasons.
* `hints.constrain` is a no-op on plain tensors and with no axes set.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.distributed import sharding as rsh
from repro.launch import specs as rspecs
from repro_torch.configs import registry as treg
from repro_torch.distributed import hints
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.tree import tree_leaves_with_names

LM_ARCHS = [a for a in treg.ARCHS if a != "fcnn_zkdl_16l"]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass
class RefMesh:                       # what the reference's rules read
    shape: dict
    axis_names: tuple


@dataclasses.dataclass
class PortMesh:                      # what the port's rules read
    shape: tuple
    mesh_dim_names: tuple


def _meshes(name):
    shape, axes = MESHES[name]
    return RefMesh(dict(zip(axes, shape)), axes), PortMesh(shape, axes)


def _norm(spec) -> tuple:
    """A spec as a tuple of entries, a one-name tuple as the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("__".join(str(getattr(k, "key", k)) for k in path), leaf)
            for path, leaf in flat]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_specs_equal_the_reference(mesh_name):
    rmesh, tmesh_ = _meshes(mesh_name)
    n, axes = 0, set()
    for arch in LM_ARCHS:
        rcfg, tcfg = rreg.get_config(arch), treg.get_config(arch)
        ref = _ref_leaves(rspecs.param_specs(rcfg))
        port = tree_leaves_with_names(tspecs.param_specs(tcfg))
        assert [k for k, _ in ref] == [k for k, _ in port], arch
        for (name, r), (_, t) in zip(ref, port):
            assert tuple(r.shape) == tuple(t.shape), (arch, name)
            path = tuple(name.split("__"))
            want = rsh.param_spec(rcfg, rmesh, path, r.shape)
            got = tsh.param_spec(tcfg, tmesh_, path, tuple(t.shape))
            assert _norm(got) == _norm(want), (arch, name, got, want)
            n += 1
            axes |= {e for e in _norm(got) if e is not None}
    assert n == 156 and axes == {"data", "model"}


@pytest.fixture
def ref_named(monkeypatch):
    """The reference's batch / cache rules without a JAX mesh: its
    NamedSharding returns the spec it was given."""
    monkeypatch.setattr(rsh, "NamedSharding", lambda mesh, spec: spec)


def _specs_by_leaf(tree, ref: bool):
    leaves = _ref_leaves(tree) if ref else tree_leaves_with_names(tree)
    return {k: _norm(v.spec if hasattr(v, "spec") else v)
            for k, v in leaves}


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_and_cache_specs_equal_the_reference(mesh_name, ref_named):
    rmesh, tmesh_ = _meshes(mesh_name)
    for arch in LM_ARCHS:
        rcfg, tcfg = rreg.get_config(arch), treg.get_config(arch)
        for shape in tspecs.SHAPE_GRID:
            r_in = rspecs.input_specs(rcfg, shape)
            t_in = tspecs.input_specs(tcfg, shape)
            if r_in["kind"] != "decode":
                got = tsh.batch_shardings(tcfg, tmesh_, t_in["batch"])
                want = rsh.batch_shardings(rcfg, rmesh, r_in["batch"])
            else:
                got = tsh.cache_shardings(tcfg, tmesh_, t_in["cache"])
                want = rsh.cache_shardings(rcfg, rmesh, r_in["cache"])
            assert _specs_by_leaf(got, False) == \
                _specs_by_leaf(want, True), (arch, shape)


def _shapes(tree, ref: bool):
    leaves = _ref_leaves(tree) if ref else tree_leaves_with_names(tree)
    return {k: (tuple(v.shape), np.dtype(str(v.dtype).replace(
        "torch.", ""))) for k, v in leaves}


def test_input_specs_and_applicable_equal_the_reference():
    assert tspecs.SHAPE_GRID == rspecs.SHAPE_GRID
    assert tspecs.SUBQUADRATIC == rspecs.SUBQUADRATIC
    for arch in LM_ARCHS:
        rcfg, tcfg = rreg.get_config(arch), treg.get_config(arch)
        for shape in tspecs.SHAPE_GRID:
            assert tspecs.applicable(tcfg, shape) == \
                rspecs.applicable(rcfg, shape), (arch, shape)
            r_in = rspecs.input_specs(rcfg, shape)
            t_in = tspecs.input_specs(tcfg, shape)
            assert t_in.keys() == r_in.keys()
            assert t_in["kind"] == r_in["kind"]
            for key in set(t_in) - {"kind"}:
                assert _shapes(t_in[key], False) == \
                    _shapes(r_in[key], True), (arch, shape, key)
                assert all(t.device.type == "meta"
                           for _, t in tree_leaves_with_names(t_in[key]))


def test_constrain_is_a_noop_without_a_mesh_or_on_plain_tensors():
    x = torch.arange(24.0).reshape(4, 6)
    hints.clear()
    assert hints.constrain(x, ("BATCH", "MODEL")) is x
    hints.set_axes(("data",), "model", {"batch": 2, "model": 3})
    try:
        assert hints.constrain(x, ("BATCH", "MODEL")) is x
        assert hints.resolve((4, 6), ("BATCH", "MODEL")) == (("data",),
                                                              "model")
        assert hints.resolve((5, 4), ("BATCH", "MODEL")) == (None, None)
        assert hints.axis_size("BATCH") == 2
        assert hints.axis_size("MODEL") == 3
    finally:
        hints.clear()
    assert hints.mesh() is None and hints.batch_axis_names() is None


def test_placements_and_local_shapes():
    from torch.distributed.tensor import Replicate, Shard
    _, m = _meshes("2x16x16")
    spec = tsh.P(("pod", "data"), None, "model")
    assert tsh.placements(m, spec) == (Shard(0), Shard(0), Shard(2))
    assert tsh.placements(m, tsh.P()) == (Replicate(),) * 3
    assert tsh.local_shape((64, 3, 32), m, spec) == (2, 3, 2)
    assert tmesh.batch_axes(m) == ("pod", "data")
    with pytest.raises(RuntimeError, match="needs 256 devices"):
        tmesh.make_production_mesh()


# the reference's public names with no counterpart in the port, and why
NO_COUNTERPART = {
    # HLO text parsers: eager execution has no HLO; the port meters the
    # collectives DTensor dispatches (steps.StepMeter)
    "repro.launch.dryrun": {"collective_bytes", "collective_bytes_scaled"},
    # JAX's persistent executable cache: the kernel build cache does its job
    "repro.util": {"enable_compilation_cache"},
}


@pytest.mark.parametrize("name", ["distributed.hints", "distributed.sharding",
                                  "launch.mesh", "launch.specs",
                                  "launch.dryrun", "util"])
def test_every_public_name_has_a_counterpart(name):
    import importlib
    import inspect

    ref = importlib.import_module(f"repro.{name}")
    port = importlib.import_module(f"repro_torch.{name}")
    public = {n for n, v in vars(ref).items()
              if not n.startswith("_") and not inspect.ismodule(v)
              and getattr(v, "__module__", ref.__name__) == ref.__name__}
    missing = public - set(vars(port)) - NO_COUNTERPART.get(ref.__name__,
                                                            set())
    assert not missing, missing
    if name == "launch.mesh":
        from repro_torch.launch import steps
        assert callable(steps.state_shardings) and callable(steps.lower_cell)
