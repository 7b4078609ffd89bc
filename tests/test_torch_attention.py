"""The port's attention (`predictionio_tpu_torch.ops.attention`) against
the JAX package's on the CPU.

Tolerances are `tests/test_attention.py`'s own: the forward within atol
1e-5 (2e-5 at S = 512), gradients (`jax.grad` against
`torch.autograd`) within atol 1e-4. A query row with no visible key (a
left-padding slot under the causal mask) is exactly 0 in both the
reference and the blockwise form. The blockwise recurrence is held
against the JAX `ring_attention` on the suite's 8-device CPU mesh."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from predictionio_tpu.ops import attention as ja
from predictionio_tpu_torch.ops import attention as pa
from predictionio_tpu_torch.parallel import mesh as pmesh

pytestmark = pytest.mark.torch

FWD_TOL, GRAD_TOL = 1e-5, 1e-4
PAD = 8                     # left-padding slots of the masked cases


def _qkv(seed=0, B=2, S=32, H=2, Dh=8):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, S, H, Dh).astype(np.float32) for _ in range(3))


def _mask(B=2, S=32):
    m = np.ones((B, S), bool)
    m[:, :PAD] = False
    m[1, :PAD + 3] = False      # rows of different padding
    return m


def _mesh(*shape_axes):
    shape = tuple(n for n, _ in shape_axes)
    axes = tuple(a for _, a in shape_axes)
    return Mesh(np.array(jax.devices()[:int(np.prod(shape))])
                .reshape(shape), axes)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


CASES = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("causal,masked", CASES)
def test_reference_forward_matches_jax(causal, masked):
    q, k, v = _qkv()
    m = _mask() if masked else None
    want = np.asarray(ja.attention_reference(
        *_j(q, k, v), causal=causal,
        kv_mask=None if m is None else jnp.asarray(m)))
    got = pa.attention_reference(
        *_t(q, k, v), causal=causal,
        kv_mask=None if m is None else torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, atol=FWD_TOL)
    if causal and masked:
        # a padding query sees no key: its row is exactly 0
        assert not got[0, :PAD].any() and not got[1, :PAD + 3].any()
        assert np.abs(got[0, PAD:]).sum(-1).min() > 0


@pytest.mark.parametrize("causal,masked", CASES)
def test_reference_gradients_match_jax(causal, masked):
    q, k, v = _qkv(seed=2)
    m = _mask() if masked else None

    def jloss(q, k, v):
        out = ja.attention_reference(
            q, k, v, causal=causal,
            kv_mask=None if m is None else jnp.asarray(m))
        return (out ** 2).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*_j(q, k, v))
    qt, kt, vt = (t.requires_grad_() for t in _t(q, k, v))
    out = pa.attention_reference(
        qt, kt, vt, causal=causal,
        kv_mask=None if m is None else torch.from_numpy(m))
    got = torch.autograd.grad((out ** 2).sum(), (qt, kt, vt))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL)


@pytest.mark.parametrize("causal,masked", CASES)
@pytest.mark.parametrize("n_blocks,mesh_axes", [
    (8, (("sp", 8),)), (4, (("data", 2), ("sp", 4)))])
def test_blockwise_matches_the_jax_ring(causal, masked, n_blocks, mesh_axes):
    """The ring's recurrence on one device against the JAX ring over the
    8-device CPU mesh (1D, and 2 data x 4 sp)."""
    q, k, v = _qkv(seed=1)
    m = _mask() if masked else None
    mesh = _mesh(*((n, a) for a, n in mesh_axes))
    want = np.asarray(ja.ring_attention(
        *_j(q, k, v), mesh, causal=causal,
        kv_mask=None if m is None else jnp.asarray(m)))
    got = pa.blockwise_attention(
        *_t(q, k, v), n_blocks=n_blocks, causal=causal,
        kv_mask=None if m is None else torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, atol=FWD_TOL)
    if causal and masked:
        assert not got[0, :PAD].any() and not got[1, :PAD + 3].any()


def test_blockwise_gradients_match_the_reference():
    """Through the streaming softmax, dead rows included, autograd gives
    finite gradients equal to the reference's (the den-where-1 rule)."""
    q, k, v = _qkv(seed=5)
    m = torch.from_numpy(_mask())
    grads = []
    for fn in (lambda *a: pa.attention_reference(*a, causal=True, kv_mask=m),
               lambda *a: pa.blockwise_attention(*a, n_blocks=4, causal=True,
                                                 kv_mask=m)):
        ts = tuple(t.requires_grad_() for t in _t(q, k, v))
        grads.append(torch.autograd.grad((fn(*ts) ** 2).sum(), ts))
    for a, b in zip(*grads):
        assert torch.isfinite(b).all()
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=GRAD_TOL)


def test_long_sequence_blockwise_matches_jax():
    """S = 512 in 8 blocks of 64, causal: within 2e-5 of the JAX oracle."""
    q, k, v = _qkv(seed=7, B=1, S=512, H=2, Dh=8)
    want = np.asarray(ja.attention_reference(*_j(q, k, v), causal=True))
    got = pa.blockwise_attention(*_t(q, k, v), n_blocks=8,
                                 causal=True).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_masked_keys_do_not_leak():
    q, k, v = _qkv(seed=3)
    m = torch.from_numpy(_mask())
    out = pa.attention_reference(*_t(q, k, v), causal=True, kv_mask=m)
    v2 = v.copy()
    v2[:, :PAD] = 99.0
    out2 = pa.attention_reference(*_t(q, k, v2), causal=True, kv_mask=m)
    np.testing.assert_allclose(out2.numpy(), out.numpy(), atol=FWD_TOL)


def test_ring_attention_falls_through_and_refuses_a_sharded_axis():
    """A trivial "sp" axis is the reference path exactly; an "sp" axis
    that spans processes is refused (only "data" may span)."""
    q, k, v = _t(*_qkv(seed=4))
    ref = pa.attention_reference(q, k, v, causal=True)
    cpu = torch.device("cpu")
    for mesh in (None, pmesh.make_mesh(pmesh.MeshSpec({"data": 8}),
                                       [cpu] * 8),
                 pmesh.make_mesh(pmesh.MeshSpec({"sp": 1}), [cpu])):
        torch.testing.assert_close(
            pa.ring_attention(q, k, v, mesh, causal=True), ref,
            rtol=0, atol=0)
    spanning = pmesh.Mesh(("sp",), (8,), (cpu,) * 8, 0, 2)
    with pytest.raises(NotImplementedError, match="'sp' axis"):
        pa.ring_attention(q, k, v, spanning, causal=True)


def test_indivisible_sequence_raises():
    q = torch.zeros((1, 30, 1, 8))
    with pytest.raises(ValueError, match="must divide"):
        pa.blockwise_attention(q, q, q, n_blocks=8)
