"""The port's `ring_attention` over a mesh (`ops.attention.ring_blocks`
between the "sp" shards, `.to` between their devices) against the JAX
package's `ring_attention` on the same inputs, on the CPU.

The seven cases of `tests/test_attention.py` (ring and 2-D mesh
forward, gradients, padding mask, long sequence, trivial axis,
indivisible sequence), each run by the port over a mesh of CPU shards
(`[torch.device("cpu")] * n`) and by the JAX package over as many of
its 8 virtual devices, at that file's tolerances: the forward within
atol 1e-5 (2e-5 at S = 512, 1e-6 on the trivial axis, which is the
reference path itself), gradients within atol 1e-4. The port is also
held to its own `attention_reference` at the same tolerances.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from predictionio_tpu.ops import attention as ja
from predictionio_tpu_torch.ops import attention as pa
from predictionio_tpu_torch.parallel import MeshSpec, make_mesh

pytestmark = pytest.mark.torch

CPU = torch.device("cpu")


def _qkv(seed=0, B=2, S=32, H=2, Dh=8):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, S, H, Dh).astype(np.float32) for _ in range(3))


def _meshes(*shape_axes):
    """(the JAX mesh, the port's mesh) of the same shape."""
    shape = tuple(n for n, _ in shape_axes)
    axes = tuple(a for _, a in shape_axes)
    n = int(np.prod(shape))
    jmesh = JMesh(np.array(jax.devices()[:n]).reshape(shape), axes)
    return jmesh, make_mesh(MeshSpec(dict(zip(axes, shape))), [CPU] * n)


def _both(q, k, v, shape_axes, **kw):
    """(the port's output, the JAX output, the port's reference) as
    numpy."""
    jmesh, pmesh = _meshes(*shape_axes)
    mask = kw.pop("kv_mask", None)
    want = np.asarray(ja.ring_attention(
        *(jnp.asarray(a) for a in (q, k, v)), jmesh, kv_mask=None
        if mask is None else jnp.asarray(mask), **kw))
    pt = tuple(torch.from_numpy(a) for a in (q, k, v))
    pm = None if mask is None else torch.from_numpy(mask)
    got = pa.ring_attention(*pt, pmesh, kv_mask=pm, **kw).numpy()
    ref = pa.attention_reference(*pt, kv_mask=pm, **kw).numpy()
    return got, want, ref


@pytest.mark.parametrize("causal", [False, True])
def test_matches_on_ring(causal):
    got, want, ref = _both(*_qkv(), ((8, "sp"),), causal=causal)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_matches_on_2d_mesh():
    """2 data x 4 sp: the batch splits over the data groups."""
    got, want, ref = _both(*_qkv(seed=1), ((2, "data"), (4, "sp")),
                           causal=True)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_gradients_match():
    q, k, v = _qkv(seed=2)
    jmesh, pmesh = _meshes((8, "sp"))

    def jloss(q, k, v):
        return (ja.ring_attention(q, k, v, jmesh, causal=True) ** 2).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    grads = []
    for fn in (lambda *a: pa.ring_attention(*a, pmesh, causal=True),
               lambda *a: pa.attention_reference(*a, causal=True)):
        ts = tuple(torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        grads.append(torch.autograd.grad((fn(*ts) ** 2).sum(), ts))
    for g, w, r in zip(grads[0], want, grads[1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-4)


def test_padding_mask():
    """Masked (left-padding) keys receive no attention: the outputs
    agree, and a masked key's value changes nothing."""
    q, k, v = _qkv(seed=3)
    mask = np.ones((2, 32), bool)
    mask[:, :8] = False
    got, want, ref = _both(q, k, v, ((8, "sp"),), causal=True,
                           kv_mask=mask)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    v2 = v.copy()
    v2[:, :8] = 99.0
    got2, _, _ = _both(q, k, v2, ((8, "sp"),), causal=True, kv_mask=mask)
    np.testing.assert_allclose(got2, got, atol=1e-5)


def test_long_sequence_over_full_ring():
    """S = 512 over an 8-way ring, 64 slots a shard."""
    got, want, ref = _both(*_qkv(seed=7, B=1, S=512, H=2, Dh=8),
                           ((8, "sp"),), causal=True)
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_trivial_axis_falls_through():
    q, k, v = _qkv(seed=4)
    want = np.asarray(ja.ring_attention(
        *(jnp.asarray(a) for a in (q, k, v)), None, causal=True))
    for mesh in (None, make_mesh(MeshSpec({"data": 4}), [CPU] * 4)):
        got = pa.ring_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                mesh, causal=True).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_indivisible_sequence_raises():
    rng = np.random.RandomState(0)
    q = rng.randn(1, 30, 1, 8).astype(np.float32)
    jmesh, pmesh = _meshes((8, "sp"))
    with pytest.raises(ValueError, match="must divide"):
        ja.ring_attention(*(jnp.asarray(q),) * 3, jmesh)
    with pytest.raises(ValueError, match="must divide"):
        pa.ring_attention(*(torch.from_numpy(q),) * 3, pmesh)
