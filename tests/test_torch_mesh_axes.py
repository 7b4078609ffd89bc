"""The port's `parallel.Mesh` addressed one axis at a time: `groups`,
`plane`, `local_part`, `axis_is_local`, `require_local`, `along`,
`shard_put` over a one-axis mesh and `data_mesh`, on meshes of CPU
entries with the process layout written out (no process group is needed
to read it).

The groups of an axis are the JAX mesh's device array with that axis
last (`np.moveaxis(mesh.devices, axis, -1)`), position for position, on
the JAX package's 8 virtual CPU devices.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JMesh

from predictionio_tpu_torch.parallel import Mesh, MeshSpec, make_mesh, spans
from predictionio_tpu_torch.parallel.mesh import (data_mesh, gather_rows,
                                                  shard_put)

pytestmark = pytest.mark.torch

CPU = torch.device("cpu")
SHAPES = [(("data", 8),), (("data", 2), ("model", 4)),
          (("data", 4), ("sp", 2)), (("model", 2), ("data", 2), ("sp", 2))]


def _both(shape_axes):
    names = tuple(a for a, _ in shape_axes)
    sizes = tuple(n for _, n in shape_axes)
    jmesh = JMesh(np.array(jax.devices()[:int(np.prod(sizes))])
                  .reshape(sizes), names)
    return jmesh, make_mesh(MeshSpec(dict(shape_axes)), [CPU] * 8)


@pytest.mark.parametrize("shape_axes", SHAPES,
                         ids=lambda s: "x".join(f"{a}{n}" for a, n in s))
def test_groups_and_planes_follow_the_jax_device_array(shape_axes):
    jmesh, mesh = _both(shape_axes)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for axis, _ in shape_axes:
        want = np.moveaxis(ids, jmesh.axis_names.index(axis), -1)
        assert [list(g) for g in mesh.groups(axis)] \
            == want.reshape(-1, jmesh.shape[axis]).tolist()
        idx = tuple(slice(None) if a == axis else 0 for a, _ in shape_axes)
        assert mesh.plane(axis).tolist() == ids[idx].tolist()
    assert mesh.groups("absent") == [(p,) for p in range(mesh.size)]
    assert mesh.plane("absent", "data").shape == (1, mesh.shape["data"])


def test_process_layout_and_along():
    """Two processes split data=4 x model=2: "model" stays inside each,
    "data" spans; `along("data")` keeps each process's data positions."""
    for pid in range(2):
        mesh = Mesh(("data", "model"), (4, 2), (CPU,) * 8, pid, 2)
        assert mesh.local == tuple(range(4 * pid, 4 * pid + 4))
        assert mesh.axis_is_local("model") and not mesh.axis_is_local("data")
        assert mesh.local_part((0, 2, 4, 6)) == ((0, 2), (4, 6))[pid]
        mesh.require_local("model")
        dm = mesh.along("data")
        assert dm.shape == {"data": 4} and dm.local == (2 * pid, 2 * pid + 1)
        with pytest.raises(NotImplementedError, match="'data' axis"):
            mesh.require_local("data")
    outer = Mesh(("model", "data"), (2, 4), (CPU,) * 8, 0, 2)
    with pytest.raises(NotImplementedError, match="'model' axis"):
        outer.along("data")
    assert make_mesh(MeshSpec({"data": 2, "sp": 2}), [CPU] * 4).along(
        "data").devices == (CPU, CPU)


def test_shard_put_over_a_one_axis_mesh_keeps_this_process_blocks():
    host = np.arange(10, dtype=np.uint8)[:, None] * np.ones((1, 3), np.uint8)
    mesh = Mesh(("data",), (4,), (CPU,) * 4, 1, 2)
    parts = shard_put(host, mesh, dtype=None)
    assert [p.dtype for p in parts] == [torch.uint8] * 2
    assert [p[:, 0].tolist() for p in parts] == [[6, 7, 8], [9, 0, 0]]
    every = shard_put(host, [CPU] * 4)
    assert every[0].dtype == torch.float32 and len(every) == 4


def test_spans_and_gather_rows_in_one_process():
    mesh = make_mesh(MeshSpec({"data": 2, "model": 1}), [CPU] * 2)
    assert spans(mesh, "data") and not spans(mesh, "model", "sp")
    assert not spans(None, "data")
    t = torch.arange(6.0).reshape(3, 2).requires_grad_()
    g = gather_rows(t, mesh)
    assert g is t


@pytest.mark.parametrize("spec", [None, {"data": 1, "model": 2},
                                  {"data": 4}, {"data": 2, "sp": 2}],
                         ids=["none", "data1xmodel2", "data4", "data2xsp2"])
def test_data_mesh_is_the_data_axis_or_one_shard(spec):
    """The sample-sharded trainers' mesh: the "data" axis (`along`) when
    it has more than one shard, else one shard on the given device."""
    mesh = None if spec is None else make_mesh(MeshSpec(spec), [CPU] * 4)
    dm = data_mesh(mesh, "cpu")
    if spans(mesh, "data"):
        assert dm == mesh.along("data")
    else:
        assert (dm.shape, dm.devices, dm.local) == ({"data": 1}, (CPU,),
                                                    (0,))
