"""The port's tiered serving (`predictionio_tpu_torch/ops/topk_tiered.py`)
and its page thread (`serving/paging.py`) against the JAX package's
`TieredTopK`, `_topk_cold` and single-device `BucketedTopK`, on the CPU.

Integer-valued factors make the hot (kernel) and cold (host BLAS) tiers
agree bit for bit, so scores and ids must be bit-identical, ties
included; the same traffic must drive both packages' pagers to the
same hot sets."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from predictionio_tpu.ingest import BiMap
from predictionio_tpu.models import recommendation as jrec
from predictionio_tpu.ops import als as jals
from predictionio_tpu.ops import topk as jt
from predictionio_tpu.ops import topk_tiered as jtt
from predictionio_tpu_torch.cli import main as cli
from predictionio_tpu_torch.ops import als as pals
from predictionio_tpu_torch.ops import topk as pt
from predictionio_tpu_torch.ops import topk_sharded as ps
from predictionio_tpu_torch.ops import topk_tiered as ptt
from predictionio_tpu_torch.serving.paging import PageManager

pytestmark = pytest.mark.torch

N, RANK = 407, 8


def _int(shape, seed, lo=-4, hi=5):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=shape).astype(np.float32)


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))


def _pair(factors, **kw):
    """The JAX and the port's tiered plan over the same catalog, warmed,
    plus the JAX single-device oracle."""
    j = jtt.TieredTopK(factors, **kw)
    p = ptt.TieredTopK(factors, device="cpu", **kw)
    assert j.warm() == p.warm()
    o = jt.BucketedTopK(factors, k=kw["k"], buckets=kw["buckets"],
                        banned_width=kw["banned_width"])
    o.warm()
    return j, p, o


@pytest.fixture(scope="module")
def plans_407():
    return _pair(_int((N, RANK), seed=7), k=6, buckets=(1, 2, 4, 8),
                 banned_width=128, hot_items=100)


@pytest.mark.parametrize("b", [1, 2, 3, 5, 8, 11])
def test_bit_identical_across_bucket_sizes(plans_407, b):
    j, p, o = plans_407
    assert np.array_equal(p.slot_gids, j.slot_gids)    # the same hot set
    rng = np.random.default_rng(b)
    vecs = rng.integers(-4, 5, size=(b, RANK)).astype(np.float32)
    bans = [sorted(rng.choice(N, size=int(rng.integers(0, 20)),
                              replace=False).tolist()) for _ in range(b)]
    got = p(vecs, bans)
    _same(got, j(vecs, bans))
    _same(got, o(vecs, bans))


def test_bans_in_both_tiers_no_duplicates(plans_407):
    j, p, o = plans_407
    vecs = np.ones((3, RANK), np.float32)
    bans = [list(range(90, 110)), list(range(0, 100)), [99, 100, 406]]
    got = p(vecs, bans)
    _same(got, j(vecs, bans))
    _same(got, o(vecs, bans))
    for row in range(3):
        assert len(set(got[1][row].tolist())) == 6
    assert not set(got[1][1].tolist()) & set(range(100))


def test_device_tensor_queries(plans_407):
    j, p, _ = plans_407
    vecs = _int((4, RANK), seed=4)
    _same(p(torch.from_numpy(vecs), [[]] * 4), j(vecs, [[]] * 4))


def test_k_above_hot_items():
    j, p, o = _pair(_int((N, RANK), seed=7), k=24, buckets=(1, 2),
                    banned_width=16, hot_items=10)
    vecs = _int((2, RANK), seed=5, lo=-3, hi=4)
    for bans in ([[], [3, 4, 5]], [[0, 1, 2, 3, 4, 5, 6, 7, 8, 9], []]):
        got = p(vecs, bans)
        _same(got, j(vecs, bans))
        _same(got, o(vecs, bans))


def test_all_banned_matches_oracle():
    j, p, o = _pair(_int((N, RANK), seed=7), k=6, buckets=(1,),
                    banned_width=512, hot_items=100)
    vecs = np.ones((1, RANK), np.float32)
    bans = [list(range(N))]
    got = p(vecs, bans)
    _same(got, j(vecs, bans))
    _same(got, o(vecs, bans))
    np.testing.assert_array_equal(got[1][0], np.arange(6))


def test_swap_factors_roundtrip():
    f = _int((N, RANK), seed=7)
    j, p, o = _pair(f, k=6, buckets=(1, 2), banned_width=16, hot_items=100)
    vecs = _int((2, RANK), seed=2)
    prev = p.swap_factors(f * 2.0)
    j.swap_factors(f * 2.0)
    np.testing.assert_array_equal(prev, f)
    _same(p(vecs, [[], [1]]), j(vecs, [[], [1]]))
    p.swap_factors(prev)
    _same(p(vecs, [[], [1]]), o(vecs, [[], [1]]))
    with pytest.raises(ValueError, match="catalog changed"):
        p.swap_factors(np.ones((3, RANK), np.float32))


def test_fits_contract(plans_407):
    j, p, _ = plans_407
    for max_banned, k in ((128, 6), (129, 6), (4, 7), (0, 1)):
        assert p.fits(max_banned=max_banned, k=k) == j.fits(
            max_banned=max_banned, k=k)
    assert p.resident_per_device_bytes() == 0.0
    assert p.factors.shape == (100, RANK) and p.max_bucket == 8


@pytest.mark.parametrize("case", ["random", "ties", "all_tied", "k_ge_n",
                                  "masked"])
def test_topk_cold_matches_jax(case):
    rng = np.random.default_rng(3)
    if case == "random":
        scores, k = rng.standard_normal((4, 500)).astype(np.float32), 10
    elif case == "ties":
        scores, k = rng.integers(-3, 4, (4, 500)).astype(np.float32), 10
    elif case == "all_tied":
        scores, k = np.zeros((2, 300), np.float32), 7
    elif case == "k_ge_n":
        scores, k = rng.integers(-3, 4, (3, 8)).astype(np.float32), 9
    else:
        scores = rng.integers(-3, 4, (3, 200)).astype(np.float32)
        scores[:, :150] = ptt._MASKED
        scores[1, 150:] = np.float32(pt.NEG_INF)
        k = 12
    _same(ptt._topk_cold(scores, k), jtt._topk_cold(scores, k))


def _popular_factors(n=400, lo=200, hi=280, boost=20.0):
    """Items [lo, hi) dominate dim 0, outside the initial hot slab."""
    f = _int((n, RANK), seed=11, lo=-2, hi=3)
    f[lo:hi, 0] += np.float32(boost)
    return f


def _traffic(rng, batch=4):
    vecs = rng.integers(0, 4, size=(batch, RANK)).astype(np.float32)
    vecs[:, 0] = 3.0
    return vecs


def test_paging_converges_like_jax_and_stays_exact():
    f = _popular_factors()
    j, p, o = _pair(f, k=10, buckets=(1, 2, 4), banned_width=16,
                    hot_items=100)
    rng = np.random.default_rng(2)

    def traffic(batches):
        for _ in range(batches):
            vecs = _traffic(rng)
            got = p(vecs, [()] * 4)
            _same(got, j(vecs, [()] * 4))
            _same(got, o(vecs, [()] * 4))

    traffic(15)
    assert p.hit_ratio() == j.hit_ratio() < 0.5
    assert p.fold_accesses() == j.fold_accesses() == 15 * 4 * 10
    np.testing.assert_array_equal(p._ewma, j._ewma)
    warmed, calls = set(p._hot._warm), p._hot.calls
    promoted = p.rebalance()
    assert promoted == j.rebalance() > 0
    # the slab swapped in place: no bucket warmed or launched again
    assert p._hot._warm == warmed and p._hot.calls == calls
    np.testing.assert_array_equal(p.slot_gids, j.slot_gids)
    p.hits = p.served = 0
    traffic(25)
    assert p.hit_ratio() >= 0.9
    assert p.stats()["hot_items"] == 100 and p.promotions_total == promoted


def test_stationary_traffic_never_thrashes():
    f = _popular_factors()
    p = ptt.TieredTopK(f, k=10, buckets=(4,), banned_width=8,
                       hot_items=100, device="cpu")
    p.warm()
    vecs = np.ones((4, RANK), np.float32)
    vecs[:, 0] = 3.0
    for _ in range(10):
        p(vecs, [()] * 4)
    p.fold_accesses()
    assert p.rebalance() > 0
    pages = p.page_count
    for _ in range(6):
        p(vecs, [()] * 4)
    p.fold_accesses()
    assert p.rebalance() == 0 and p.page_count == pages


def test_fold_accounts_and_decays(plans_407):
    j, p, _ = plans_407
    p.fold_accesses()
    j.fold_accesses()
    vecs = np.ones((1, RANK), np.float32)
    p(vecs, [()])
    j(vecs, [()])
    assert p.fold_accesses() == j.fold_accesses() == 6
    np.testing.assert_array_equal(p._ewma, j._ewma)
    peak = p._ewma.max()
    assert p.fold_accesses() == 0
    assert p._ewma.max() < peak


@pytest.mark.parametrize("tier,frac", [
    ("", ""), ("on", ""), ("1", "0.25"), ("TRUE", "2"), ("off", "0"),
    ("false", "-1"), ("auto", "x"), ("bogus", "0.5")])
def test_tier_knobs_match_jax(tier, frac, monkeypatch):
    monkeypatch.setenv("PIO_SERVE_TIER", tier)
    monkeypatch.setenv("PIO_TIER_HOT_FRAC", frac)
    assert ptt.tier_mode() == jtt.tier_mode()
    assert ptt.hot_frac() == jtt.hot_frac()


# -- the page thread -----------------------------------------------------------

def test_page_manager_tick_promotes():
    f = _int((120, RANK), seed=9, lo=-2, hi=3)
    f[60:90, 0] += np.float32(9.0)
    plan = ptt.TieredTopK(f, k=5, buckets=(1,), banned_width=8,
                          hot_items=20, device="cpu")
    plan.warm()
    mgr = PageManager(interval_s=60.0)       # ticked by hand
    mgr.bind([plan])
    vecs = np.zeros((3, RANK), np.float32)
    vecs[:, 0] = 2.0
    plan(vecs, [()] * 3)
    assert mgr.tick() > 0
    assert plan.page_count == 1 and plan.promotions_total > 0


def test_page_manager_thread_lifecycle():
    f = _int((40, 4), seed=10, lo=-2, hi=3)
    f[20:30, 0] += np.float32(9.0)
    plan = ptt.TieredTopK(f, k=3, buckets=(1,), banned_width=4,
                          hot_items=10, device="cpu")
    plan.warm()
    mgr = PageManager(interval_s=0.02)
    mgr.bind([plan])
    mgr.start()
    try:
        thread = mgr._thread
        assert thread.is_alive() and thread.daemon
        mgr.start()                           # idempotent
        assert mgr._thread is thread
        vecs = np.zeros((2, 4), np.float32)
        vecs[:, 0] = 2.0
        plan(vecs, [()] * 2)
        deadline = time.perf_counter() + 5.0
        while plan.page_count == 0 and time.perf_counter() < deadline:
            time.sleep(0.01)
        assert plan.page_count > 0, "page thread never rebalanced"
    finally:
        mgr.stop()
    assert mgr._thread is None and not thread.is_alive()


def test_page_manager_survives_a_failing_plan():
    class _Poison:
        def fold_accesses(self):
            raise RuntimeError("boom")

    class _Counting:
        def __init__(self):
            self.calls = 0

        def fold_accesses(self):
            self.calls += 1

        def rebalance(self, **kw):
            return 2

    good = _Counting()
    mgr = PageManager(interval_s=60.0)
    mgr.bind([_Poison(), good])
    assert mgr.tick() == 2 and good.calls == 1


def test_rebalance_races_serving_threads():
    """Serve threads (more than cores) and a rebalancing thread share
    the slot map and the slab: every answer must still be the oracle's.
    A serve read of new slot ids against the old slab, or the reverse,
    would return wrong global ids."""
    import sys
    f = _popular_factors()
    plan = ptt.TieredTopK(f, k=10, buckets=(1, 2, 4), banned_width=16,
                          hot_items=60, device="cpu")
    plan.warm()
    oracle = jt.BucketedTopK(f, k=10, buckets=(4,), banned_width=16)
    oracle.warm()
    rng = np.random.default_rng(4)
    batches = [_traffic(rng) for _ in range(8)]
    want = [oracle(v, [()] * 4) for v in batches]
    stop = threading.Event()
    errors = []

    def serve(worker):
        for i in range(30):
            j = (worker + i) % len(batches)
            got = plan(batches[j], [()] * 4)
            if not (np.array_equal(got[1], want[j][1])
                    and np.array_equal(got[0], want[j][0])):
                errors.append((worker, i))

    def page():
        flip = 0
        while not stop.is_set():
            # alternate the favoured block so every pass promotes
            plan._ewma[:] = 0.0
            lo = 200 if flip else 0
            plan._ewma[lo:lo + 60] = 1.0
            plan.rebalance()
            flip ^= 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        pager = threading.Thread(target=page, daemon=True)
        pager.start()
        workers = [threading.Thread(target=serve, args=(w,), daemon=True)
                   for w in range(16)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
        stop.set()
        pager.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in workers) and not pager.is_alive()
    assert not errors, errors[:5]
    assert plan.page_count > 2


# -- the deploy path ------------------------------------------------------------

N_USERS, N_ITEMS, E2E_RANK = 30, 250, 16
USERS = [f"u{n}" for n in range(N_USERS)]
ITEMS = [f"i{n}" for n in range(N_ITEMS)]


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def test_tiered_deploy_pages_and_answers_as_jax(monkeypatch):
    """`PIO_SERVE_TIER=on` makes the deploy tier its catalog; the server
    runs a page thread for the plan's lifetime and stops it with itself,
    and every answer equals the JAX template's."""
    monkeypatch.setenv("PIO_SERVE_TIER", "on")
    monkeypatch.setenv("PIO_TIER_HOT_FRAC", "0.5")
    monkeypatch.setenv("PIO_TIER_PAGE_INTERVAL_S", "0.05")
    rng = np.random.default_rng(12)
    x = rng.integers(-4, 5, (N_USERS, E2E_RANK)).astype(np.float32)
    y = rng.integers(-4, 5, (N_ITEMS, E2E_RANK)).astype(np.float32)
    model = pals.als_model_from_numpy(x, y, USERS, ITEMS, device="cpu")
    server = cli.deploy(model, port=0, batch_max=8)
    try:
        plan = server.deployment.algos[0]._serve_plan
        assert isinstance(plan, ptt.TieredTopK) and plan.hot_items == 125
        pager = server._pager
        assert pager is not None and pager._thread.is_alive()
        ref_model = jals.ALSModel(x, y, BiMap.from_keys(USERS),
                                  BiMap.from_keys(ITEMS))
        algo = jrec.ALSAlgorithm(jrec.ALSAlgorithmParams())
        algo.warm_serving(ref_model, [1, 2, 4, 8])
        for n in range(20):
            q = {"user": USERS[n % N_USERS], "num": 1 + n % 10}
            if n % 2:
                q["blackList"] = [ITEMS[j] for j in range(120, 130)]
            (_, pred), = algo.batch_predict(ref_model, [(0, jrec.Query(**q))])
            want = {"itemScores": [{"item": s.item, "score": s.score}
                                   for s in pred.itemScores]}
            assert _post(server.port, q) == want
            if n == 10:     # let the page thread fold and rebalance
                time.sleep(0.3)
        thread = pager._thread
    finally:
        server.stop()
    assert server._pager is None and not thread.is_alive()
    assert not any(t.name == "pio-torch-tier-pager" and t.is_alive()
                   for t in threading.enumerate())


def test_untiered_deploy_has_no_pager():
    rng = np.random.default_rng(13)
    x = rng.integers(-4, 5, (N_USERS, E2E_RANK)).astype(np.float32)
    y = rng.integers(-4, 5, (N_ITEMS, E2E_RANK)).astype(np.float32)
    model = pals.als_model_from_numpy(x, y, USERS, ITEMS, device="cpu")
    server = cli.deploy(model, port=0, batch_max=4)
    try:
        assert isinstance(server.deployment.algos[0]._serve_plan,
                          pt.BucketedTopK)
        assert server._pager is None
    finally:
        server.stop()


def test_slice_of_a_tiered_catalog_is_paged(monkeypatch):
    """A fleet slice that tiers itself is found behind the slice plan."""
    from predictionio_tpu_torch.serving.server import _Deployment, \
        _tiered_plans
    monkeypatch.setenv("PIO_SERVE_TIER", "on")
    monkeypatch.setenv("PIO_TIER_HOT_FRAC", "0.25")
    plan = ps.serve_plan(_int((N, RANK), seed=7), k=4, buckets=(1,),
                         banned_width=4, mesh=ps.ShardSlice(2, 1),
                         device="cpu")
    assert isinstance(plan._inner, ptt.TieredTopK)

    class _Algo:
        query_class = None
        _serve_plan = plan

    assert _tiered_plans(_Deployment([_Algo()], [None], None)) == [
        plan._inner]
