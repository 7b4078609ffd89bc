"""The port's two-tower over a device mesh (`ops.twotower.
ShardedTwoTowerNet`, `twotower_train(mesh=)`) against its own one-device
training and the JAX package's `twotower_train(mesh=)`, on the CPU.

Meshes of CPU shards over "data" = 4, "model" = 4 and "data" = 2 x
"model" = 2, from the same weights (the JAX package's `_init_params`)
and the same `RandomState` batches:
- against the port on one device: each step's loss within rtol 1e-5
  and the parameters within atol 1e-5 after the steps (the model
  shards' partial products and the data shards' gradients add up in
  another order; Adam divides each gradient by its own root mean
  square, so an ulp of a small gradient moves a weight by more than an
  ulp, the bar of `test_torch_twotower.py`'s three Adam steps);
- against the JAX mesh path after one epoch: the towers and weights
  within 5e-3 (`test_torch_twotower.py`'s one-epoch bar).
A batch whose length does not divide over "data" runs unsplit, and
tables and hidden widths that do not divide over "model" are padded
and reassembled.
"""

import numpy as np
import pytest
import torch

import jax

from predictionio_tpu.ops import twotower as jop
from predictionio_tpu.parallel import MeshSpec as JMeshSpec
from predictionio_tpu.parallel import make_mesh as jmake_mesh
from predictionio_tpu_torch.ops import twotower as pop
from predictionio_tpu_torch.parallel import Mesh, MeshSpec, make_mesh
from predictionio_tpu_torch.parallel.mesh import split_over_data

pytestmark = pytest.mark.torch

CPU = torch.device("cpu")
N_USERS, N_ITEMS, EMB, HID, OUT = 40, 32, 8, 16, 8
SPECS = [{"data": 4}, {"model": 4}, {"data": 2, "model": 2}]
IDS = ["data4", "model4", "data2xmodel2"]


def cpu_mesh(spec):
    return make_mesh(MeshSpec(spec), [CPU] * int(np.prod(list(spec.values()))))


def _jax_init(seed=0, n_users=N_USERS, hidden=HID):
    p = jop._init_params(jax.random.PRNGKey(seed), n_users, N_ITEMS, EMB,
                         hidden, OUT)
    return {k: np.asarray(v) for k, v in p.items()}


def _pairs(n=640, seed=0, n_users=N_USERS):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, n_users, n).astype(np.int32),
            rng.randint(0, N_ITEMS, n).astype(np.int32))


def _train(mesh, init, u, i, losses=None, **kw):
    args = dict(n_users=N_USERS, n_items=N_ITEMS, emb_dim=EMB, hidden=HID,
                out_dim=OUT, batch_size=128, epochs=1, seed=4,
                init_params=init)
    args.update(kw)
    return pop.twotower_train(u, i, mesh=mesh, step_losses=losses,
                              **({} if mesh is not None else
                                 {"device": "cpu"}), **args)


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_steps_match_one_device(spec):
    init = _jax_init(1)
    u, i = _pairs()
    one, got = [], []
    a = _train(None, init, u, i, one, epochs=2)
    b = _train(cpu_mesh(spec), init, u, i, got, epochs=2)
    assert len(got) == len(one) == 10
    np.testing.assert_allclose([float(x) for x in got],
                               [float(x) for x in one], rtol=1e-5)
    for name in pop.PARAM_NAMES:
        np.testing.assert_allclose(b.params[name], a.params[name],
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(b.user_emb, a.user_emb, atol=1e-5)
    np.testing.assert_allclose(b.item_emb, a.item_emb, atol=1e-5)


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_one_epoch_matches_the_jax_mesh_path(spec):
    init = _jax_init(2)
    u, i = _pairs(600, seed=3)
    kw = dict(n_users=N_USERS, n_items=N_ITEMS, emb_dim=EMB, hidden=HID,
              out_dim=OUT, batch_size=128, epochs=1, seed=4)
    # the JAX loop shards its batches over "data", which its mesh needs
    jspec = {"data": 1, **spec}
    want = jop.twotower_train(u, i, init_params=init,
                              mesh=jmake_mesh(JMeshSpec(jspec)), **kw)
    got = pop.twotower_train(u, i, init_params=init, mesh=cpu_mesh(spec),
                             **kw)
    for a, b in ((got.item_emb, want.item_emb),
                 (got.user_emb, want.user_emb)):
        assert np.abs(a - b).max() < 5e-3
    for k in pop.PARAM_NAMES:
        assert np.abs(got.params[k] - want.params[k]).max() < 5e-3, k


def test_sharded_net_loss_and_gradients_equal_one_device():
    """One batch over data 2 x model 2: the loss within rtol 1e-6 and
    every reassembled gradient within atol 1e-6 of `TwoTowerNet`'s."""
    params = pop.params_from_jax(_jax_init(3))
    u, i = (torch.from_numpy(a.astype(np.int64)) for a in _pairs(64, 5))
    net = pop.TwoTowerNet(params, "cpu")
    want = net.loss(u, i, 0.1)
    want_g = torch.autograd.grad(want, list(net.parameters()))
    sharded = pop.ShardedTwoTowerNet(params, cpu_mesh({"data": 2,
                                                       "model": 2}))
    assert split_over_data(sharded.mesh, len(u))
    got = sharded.loss(u, i, 0.1)
    got_g = torch.autograd.grad(got, sharded.parameters())
    np.testing.assert_allclose(float(got.detach()), float(want.detach()),
                               rtol=1e-6)
    for k, name in enumerate(pop.PARAM_NAMES):
        parts = [g.numpy() for g in got_g[2 * k:2 * k + 2]]
        full = np.concatenate(parts, axis=1 if name.endswith("_w1") else 0)
        np.testing.assert_allclose(full, want_g[k].numpy(), atol=1e-6,
                                   err_msg=name)


def test_indivisible_batches_and_widths():
    """data = 3 against batch 128 runs every batch unsplit; 37 users and
    18 hidden units over model = 4 are padded and reassembled to their
    shapes; both within the one-device bars."""
    init = _jax_init(4, n_users=37, hidden=18)
    u, i = _pairs(384, seed=6, n_users=37)
    kw = dict(n_users=37, hidden=18)
    a = _train(None, init, u, i, **kw)
    for spec in ({"data": 3}, {"model": 4}, {"data": 3, "model": 2}):
        b = _train(cpu_mesh(spec), init, u, i, **kw)
        for name in pop.PARAM_NAMES:
            assert b.params[name].shape == init[name].shape
            np.testing.assert_allclose(b.params[name], a.params[name],
                                       atol=1e-5, err_msg=name)


def test_a_model_axis_across_processes_is_refused():
    spanning = Mesh(("model", "data"), (2, 2), (CPU,) * 4, 0, 2)
    u, i = _pairs(64)
    with pytest.raises(NotImplementedError, match="'model' axis"):
        _train(spanning, _jax_init(), u, i, batch_size=32)
