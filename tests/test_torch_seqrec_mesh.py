"""The port's seqrec over a device mesh (`seqrec_train(mesh=)`: the
batch over "data", the sequence over "sp" through the ring) against its
own one-device training and the JAX package's mesh path, on the CPU.

`tests/test_seqrec.py`'s mesh cases on port meshes of CPU shards:
- at init, the mesh's loss within rtol 1e-5 and every gradient within
  atol 1e-5 of one device's (the ring's streaming softmax against the
  plain one, and the data shards' gradients summed in another order);
- after one epoch from the JAX package's weights: the parameters within
  atol 1e-5 of the port's one-device run (`test_torch_seqrec.py`'s
  three-Adam-step bar) and the item table within 5e-3 of the JAX mesh
  path's (`tests/test_seqrec.py`'s own bar between its mesh and one
  device);
- training over data 4 x sp 2 stays finite and passes the model's
  sanity check.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JMesh

from predictionio_tpu.ops import seqrec as jop
from predictionio_tpu_torch.ops import seqrec as pop
from predictionio_tpu_torch.parallel import Mesh, MeshSpec, make_mesh
from test_torch_seqrec import _batch, _jax_init, _markov_events

pytestmark = pytest.mark.torch

CPU = torch.device("cpu")
N_ITEMS, S, D, H, L = 30, 8, 16, 2, 2


def cpu_mesh(spec):
    return make_mesh(MeshSpec(spec), [CPU] * int(np.prod(list(spec.values()))))


@pytest.mark.parametrize("spec", [{"data": 4, "sp": 2}, {"sp": 8},
                                  {"data": 4}, {"data": 2, "model": 2}],
                         ids=["data4xsp2", "sp8", "data4", "data2xmodel2"])
def test_mesh_and_one_device_agree_at_init(spec):
    seqs, targets = (torch.from_numpy(a.astype(np.int64)) for a in _batch())
    net = pop.SeqRecNet(pop.params_from_jax(_jax_init()), n_items=N_ITEMS,
                        n_heads=H, device="cpu")
    params = list(net.parameters())
    grads = []
    for mesh in (None, cpu_mesh(spec)):
        loss = net.loss(seqs, targets, 0.07, mesh)
        grads.append((float(loss.detach()),
                      torch.autograd.grad(loss, params)))
    np.testing.assert_allclose(grads[1][0], grads[0][0], rtol=1e-5)
    for (name, _), a, b in zip(net.named_parameters(), grads[0][1],
                               grads[1][1]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5,
                                   err_msg=name)


def test_one_epoch_matches_one_device_and_the_jax_mesh():
    u, i, t, n_items = _markov_events(n_users=260, seed=2)
    seqs, targets = jop.build_sequences(u, i, t, n_items=n_items, seq_len=8)
    seqs, targets = seqs[:256], targets[:256]
    init = _jax_init(0, n_items=n_items, seq_len=8, dim=32, n_layers=1)
    kw = dict(n_items=n_items, seq_len=8, dim=32, n_heads=2, n_layers=1,
              batch_size=128, epochs=1, init_params=init)
    want = jop.seqrec_train(seqs, targets, mesh=JMesh(
        np.array(jax.devices()).reshape(4, 2), ("data", "sp")), **kw)
    one = pop.seqrec_train(seqs, targets, device="cpu", **kw)
    got = pop.seqrec_train(seqs, targets, mesh=cpu_mesh({"data": 4,
                                                         "sp": 2}), **kw)
    assert np.abs(got.item_emb - want.item_emb).max() < 5e-3
    np.testing.assert_allclose(got.item_emb, one.item_emb, atol=1e-5)
    for k in ("wq", "wk", "wv", "wo", "w1", "w2"):
        np.testing.assert_allclose(got.params["l0"][k], one.params["l0"][k],
                                   atol=1e-5, err_msg=k)


def test_mesh_training_with_ring_attention():
    u, i, t, n_items = _markov_events(n_users=300, seed=1)
    seqs, targets = jop.build_sequences(u, i, t, n_items=n_items, seq_len=8)
    m = pop.seqrec_train(seqs, targets, n_items=n_items, seq_len=8, dim=32,
                         n_heads=2, n_layers=1, batch_size=128, epochs=2,
                         seed=0, mesh=cpu_mesh({"data": 4, "sp": 2}))
    vecs = pop.seqrec_encode(m, seqs[:64], device="cpu")
    assert np.isfinite(vecs).all()
    m.sanity_check()


def test_refusals():
    """A sequence that does not divide over "sp" raises ValueError, as
    the JAX ring does; an "sp" axis across processes is refused."""
    seqs, targets = _batch()
    kw = dict(n_items=N_ITEMS, seq_len=S, dim=D, n_heads=H, n_layers=L,
              batch_size=16, epochs=1, init_params=_jax_init())
    with pytest.raises(ValueError, match="must divide"):
        pop.seqrec_train(seqs, targets, mesh=cpu_mesh({"sp": 3}), **kw)
    spanning = Mesh(("sp", "data"), (2, 2), (CPU,) * 4, 0, 2)
    with pytest.raises(NotImplementedError, match="'sp' axis"):
        pop.seqrec_train(seqs, targets, mesh=spanning, **kw)
