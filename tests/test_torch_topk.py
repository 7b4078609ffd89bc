"""The port's top-k serving ops (`predictionio_tpu_torch/ops/topk.py`)
against the JAX package's single-device ones: `BucketedTopK` (warmed
with the XLA chain and with the fused kernel in interpret mode),
`topk_scores`, `topk_scores_filtered`, `build_mask` and
`DispatchPolicy`. Integer-valued factors make every product exact, so
scores and ids must be bit-identical, ties included."""

import jax
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import topk as jt
from predictionio_tpu_torch.ops import fused_topk
from predictionio_tpu_torch.ops import topk as pt

pytestmark = pytest.mark.torch

N, RANK = 203, 8


def _int(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-4, 5, size=shape).astype(np.float32)


def _ban_rows(b, seed):
    rng = np.random.default_rng(seed)
    cases = [[], [0, 7, 202], list(range(120, 136)),
             sorted(rng.choice(N, size=16, replace=False).tolist())]
    return [cases[r % len(cases)] for r in range(b)]


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))


@pytest.fixture(params=["off", "on"])
def plans(request, monkeypatch):
    """The JAX plan warmed unfused (XLA chain) or fused (Pallas
    interpret mode), and the port's plan on the CPU, same catalog."""
    factors = _int((N, RANK), seed=1)
    monkeypatch.setenv("PIO_SERVE_FUSED", request.param)
    ref = jt.BucketedTopK(factors, k=6, buckets=(1, 2, 4, 8),
                          banned_width=16)
    assert ref.warm() == 4
    assert ref.fused_buckets == (4 if request.param == "on" else 0)
    port = pt.BucketedTopK(factors, k=6, buckets=(1, 2, 4, 8),
                           banned_width=16, device="cpu")
    assert port.warm() == 4
    return ref, port


@pytest.mark.parametrize("b", [1, 2, 3, 5, 8])
def test_bucketed_bit_identical_across_padding(plans, b):
    ref, port = plans
    vecs = _int((b, RANK), seed=10 + b)
    bans = _ban_rows(b, seed=b)
    _same(port(vecs, bans), ref(vecs, bans))


def test_bucketed_chunks_past_largest_bucket(plans):
    ref, port = plans
    vecs = _int((19, RANK), seed=77)
    bans = _ban_rows(19, seed=77)
    calls = port.calls
    _same(port(vecs, bans), ref(vecs, bans))
    assert port.calls - calls == 3   # 8 + 8 + 3 (padded to 4)


def test_bucketed_swap_factors(plans):
    ref, port = plans
    new = _int((N, RANK), seed=99)
    ref.swap_factors(new)
    prev = port.swap_factors(new)
    np.testing.assert_array_equal(prev.numpy(), _int((N, RANK), seed=1))
    vecs = _int((5, RANK), seed=5)
    bans = _ban_rows(5, seed=5)
    _same(port(vecs, bans), ref(vecs, bans))
    with pytest.raises(ValueError):
        port.swap_factors(_int((N + 1, RANK), seed=2))


def test_bucketed_device_tensor_input(plans):
    """Query vectors already on the plan's device (the serving path
    gathers them there) give the same answer as host arrays."""
    ref, port = plans
    vecs = _int((3, RANK), seed=3)
    bans = _ban_rows(3, seed=3)
    _same(port(torch.from_numpy(vecs), bans), ref(vecs, bans))


def test_bucketed_contract():
    factors = _int((N, RANK), seed=1)
    plan = pt.BucketedTopK(factors, k=6, buckets=(1, 3, 300),
                           banned_width=10, device="cpu")
    assert plan.buckets == (1, 4)       # pow2; above the kernel's 128 dropped
    assert plan.banned_width == 16
    assert not plan.fits(max_banned=0, k=1)   # not warmed yet
    with pytest.raises(RuntimeError, match="not warmed"):
        plan(_int((1, RANK), seed=0), [[]])
    assert plan.warm() == 2 and plan.warm() == 0
    assert plan.fits(max_banned=16, k=6)
    assert not plan.fits(max_banned=17, k=6)
    assert not plan.fits(max_banned=0, k=7)
    with pytest.raises(ValueError, match="above the fused kernel"):
        pt.BucketedTopK(_int((100, 4), seed=0), k=fused_topk.MAX_K + 1,
                        device="cpu")


@pytest.mark.parametrize("path", ["host", "device"])
def test_topk_scores_matches_jax(path, monkeypatch):
    cells = 0 if path == "device" else 1 << 40
    monkeypatch.setattr(jt, "HOST_CROSSOVER_CELLS", cells)
    monkeypatch.setattr(pt, "HOST_CROSSOVER_CELLS", cells)
    factors = _int((N, RANK), seed=2)
    vecs = _int((6, RANK), seed=3)
    mask = np.ones((6, N), bool)
    mask[0, :100] = False
    mask[1] = False
    mask[2, ::3] = False
    before = dict(pt.DISPATCH_COUNTS)
    for k in (1, 10, N):
        _same(pt.topk_scores(vecs, factors, mask, k=k, device="cpu"),
              jt.topk_scores(vecs, factors, mask, k=k))
    assert pt.DISPATCH_COUNTS[path] - before[path] == 3


@pytest.mark.parametrize("path", ["host", "device"])
def test_topk_scores_filtered_matches_jax(path, monkeypatch):
    cells = 0 if path == "device" else 1 << 40
    monkeypatch.setattr(jt, "HOST_CROSSOVER_CELLS", cells)
    monkeypatch.setattr(pt, "HOST_CROSSOVER_CELLS", cells)
    factors = _int((N, RANK), seed=4)
    vecs = _int((5, RANK), seed=5)
    bans = _ban_rows(5, seed=6)
    bans[4] = list(range(N))          # everything banned
    for k in (3, 10):
        _same(pt.topk_scores_filtered(vecs, factors, bans, k=k,
                                      device="cpu"),
              jt.topk_scores_filtered(vecs, factors, bans, k=k))


def test_topk_scores_on_tensors_uses_their_device():
    factors = _int((N, RANK), seed=6)
    vecs = _int((2, RANK), seed=7)
    mask = np.ones((2, N), bool)
    _same(pt.topk_scores(torch.from_numpy(vecs), torch.from_numpy(factors),
                         mask, k=5),
          jt.topk_scores(vecs, factors, mask, k=5))


def test_build_mask_matches_jax():
    for black, white in [((), None), ((1, 5), None), ((2,), (2, 3, 9)),
                         ((), ())]:
        np.testing.assert_array_equal(
            pt.build_mask(12, black, white, batch=3),
            jt.build_mask(12, black, white, batch=3))


def test_dispatch_policy_matches_jax(monkeypatch):
    """The same observations drive both policies to the same choices
    and snapshots: cold start, exploration probes, promotion, in-flight
    coalescing, restore."""
    for mod in (jt, pt):
        monkeypatch.setattr(mod, "HOST_CROSSOVER_CELLS", 1 << 22)
        monkeypatch.setattr(mod, "PROMOTE_FLOOR_CELLS", 1 << 16)
        monkeypatch.setattr(mod, "EXPLORE_EVERY", 4)
    a, b = jt.DispatchPolicy(), pt.DispatchPolicy()
    sizes = [1 << 10, 1 << 17, 1 << 20, 1 << 22, 1 << 18] * 3
    trace = []
    for i, cells in enumerate(sizes):
        ca, cb = a.choose(cells), b.choose(cells)
        assert ca == cb
        trace.append(ca)
        seconds = 1e-3 * (1 + i % 3)
        for p in (a, b):
            p.observe(ca, cells, seconds)
            if i % 4 == 0:
                p.host_begin()
        assert a.snapshot() == b.snapshot()
    assert "device" in trace and "host" in trace
    for p in (a, b):
        p.observe("sharded", 100, 0.5)
        p.observe("host", 0, 1.0)          # ignored: no cells
        p.observe("device", 10, None)      # ignored: no time
        p.host_end()
    assert a.snapshot() == b.snapshot()
    state = {"host_s_per_cell": 2e-9, "device_call_s": 1e-4,
             "sharded_call_s": "junk", "host_inflight": 7}
    a2, b2 = jt.DispatchPolicy(), pt.DispatchPolicy()
    a2.restore(state)
    b2.restore(state)
    assert a2.snapshot() == b2.snapshot()
    assert b2.snapshot()["host_inflight"] == 0
    for cells in (1 << 16, 1 << 18, 1 << 21):
        assert a2.choose(cells) == b2.choose(cells)


# -- the cosine path (similar-product and e-commerce templates) -------------

def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _similar_mask(b, n, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((b, n)) > 0.3
    mask[0] = True
    if b > 2:
        mask[2] = False
        mask[2, :3] = True     # fewer allowed items than k
    return mask


def _close(p, j):
    """Ids equal, scores to rtol 1e-5 (fp32 summation order)."""
    np.testing.assert_array_equal(np.asarray(p[1]), np.asarray(j[1]))
    np.testing.assert_allclose(np.asarray(p[0]), np.asarray(j[0]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("on", ["host", "cpu_tensors"])
@pytest.mark.parametrize("b", [1, 5])
def test_topk_similar_matches_jax_raw(b, on):
    factors = _real((N, RANK), seed=11)
    factors[7] = 0.0                   # a zero row scores 0, not NaN
    vecs = _real((b, RANK), seed=12 + b)
    mask = _similar_mask(b, N, seed=b)
    want = jax.device_get(jt._topk_similar_raw(vecs, factors, mask, k=10))
    if on == "host":
        got = pt.topk_similar(vecs, factors, mask, k=10, device="cpu")
    else:
        got = pt.topk_similar(torch.from_numpy(vecs),
                              torch.from_numpy(factors),
                              torch.from_numpy(mask), k=10)
    _close(got, want)
    assert isinstance(got[0], np.ndarray) and got[1].dtype == np.int32


def test_bucketed_similar_matches_jax_raw_and_plan():
    factors = _real((N, RANK), seed=21)
    plan = pt.BucketedSimilar(factors, k=10, buckets=(1, 2, 4, 8),
                              device="cpu")
    jplan = jt.BucketedSimilar(factors, k=10, buckets=(1, 2, 4, 8))
    assert plan.warm() == 4 and plan.warm() == 0 and plan.calls == 4
    jplan.warm()
    assert plan.fits(k=10) and not plan.fits(k=11)
    for b in (1, 3, 8, 19):            # 19: chunks past the largest bucket
        vecs = _real((b, RANK), seed=22 + b)
        mask = _similar_mask(b, N, seed=b)
        got = plan(vecs, mask)
        assert got[0].shape == (b, 10)
        _close(got, jax.device_get(jt._topk_similar_raw(vecs, factors, mask,
                                                         k=10)))
        _close(got, jplan(vecs, mask))
    assert plan.calls == 4 + 1 + 1 + 1 + 3


def test_bucketed_similar_swap_and_contract():
    factors = _real((N, RANK), seed=31)
    plan = pt.BucketedSimilar(torch.from_numpy(factors), k=5, buckets=(2,))
    with pytest.raises(RuntimeError, match="not warmed"):
        plan(factors[:1], np.ones((1, N), bool))
    plan.warm()
    assert plan.resident_per_device_bytes() == 2 * N * RANK * 4
    new = _real((N, RANK), seed=32)
    prev = plan.swap_factors(new)
    assert torch.equal(prev, torch.from_numpy(factors))
    vecs, mask = _real((2, RANK), seed=33), np.ones((2, N), bool)
    _close(plan(vecs, mask),
           jax.device_get(jt._topk_similar_raw(vecs, new, mask, k=5)))
    with pytest.raises(ValueError, match="catalog changed"):
        plan.swap_factors(new[:-1])
