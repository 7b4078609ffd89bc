"""The port's streaming fold-in (`predictionio_tpu_torch.streaming`,
`ops.als.fold_in_rows`, the recommendation template's `fold_in`) against
the JAX package's, on the CPU over SQLITE metadata and PEVLOG events:

  - the delta scan equals the tail of a full scan, and a tombstone, an
    external id, a rewritten segment, the byte budget or a driver
    without a delta path invalidates it;
  - `fold_in_rows` matches the normal equations (`np.linalg.solve`,
    atol 1e-4, explicit and implicit) and the JAX `fold_in_rows`
    (Cholesky at rank <= 16 within 5e-5, CG from zero at rank 64 within
    1e-5 on a well-conditioned system); a row does not depend on the
    other rows of the call; long histories keep their newest events;
  - the template's `fold_in` leaves untouched rows bit-identical, and
    its touched rows agree with the JAX template's `fold_in` on the same
    model and store within 1e-4;
  - the `Refresher` tick protocol against a live `PredictionServer`:
    baseline -> noop -> folded with the warmed plan kept (no re-warm),
    deletes and new items falling back to the full rebuild, a model in
    hand or a store without a watermark leaving the server alone,
    foreign events folding nothing, a raising tick counted as failed,
    and a `swap_factors` that raises rolling back with no failed request
    and the watermark where it was; the history a fold reads, extended
    by each delta, equal to a full scan."""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from predictionio_tpu.data import DataMap as JDataMap
from predictionio_tpu.data import Event as JEvent
from predictionio_tpu.data.storage import App as JApp
from predictionio_tpu.data.storage import StorageRegistry as JRegistry
from predictionio_tpu.ingest.bimap import BiMap as JBiMap
from predictionio_tpu.models import recommendation as jrec
from predictionio_tpu.ops import als as jals
from predictionio_tpu.streaming import scan_delta as jscan_delta
from predictionio_tpu.streaming.updaters import FoldContext as JFoldContext
from predictionio_tpu_torch.cli import main as cli_main
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.core.workflow import CoreWorkflow
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import (AccessKey, App,
                                                 StorageRegistry)
from predictionio_tpu_torch.data.storage.base import DeltaInvalidated
from predictionio_tpu_torch.ingest.bimap import BiMap
from predictionio_tpu_torch.models import recommendation as rec
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.streaming import Refresher, scan_delta
from predictionio_tpu_torch.streaming.delta import Delta
from predictionio_tpu_torch.streaming.updaters import (FoldContext,
                                                       extend_bimap)

pytestmark = pytest.mark.torch

SPEC = dict(entity_type="user", event_names=["rate"],
            value_spec={"*": 1.0}, require_target=True)


def pev_config(tmp_path):
    """SQLITE metadata + PEVLOG events: the delta-capable pairing."""
    return {
        "PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
        "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.db"),
        "PIO_STORAGE_SOURCES_PEV_TYPE": "PEVLOG",
        "PIO_STORAGE_SOURCES_PEV_PATH": str(tmp_path / "pevlog"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "PEV",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
    }


def _rate(user, item, rating, ev=None):
    E, D = (Event, DataMap) if ev is None else ev
    return E(event="rate", entity_type="user", entity_id=user,
             target_entity_type="item", target_entity_id=item,
             properties=D({"rating": float(rating)}))


def _seed_ratings(events, app_id, n_users=12, n_items=9):
    """User u loves the i % 3 == u % 3 cluster: a signal strong enough
    that fold-in and retrain agree on what a user likes."""
    rng = np.random.RandomState(7)
    batch = []
    for u in range(n_users):
        for i in range(n_items):
            if rng.rand() > 0.7:
                continue
            batch.append(_rate(f"u{u}", f"i{i}",
                               5.0 if i % 3 == u % 3 else 1.0))
    events.insert_batch(batch, app_id)


PARAMS = dict(rank=4, num_iterations=6, seed=1)


@pytest.fixture()
def trained_pev(tmp_path):
    """A PEVLOG-backed registry with a trained recommendation instance
    (on the CPU) and what a fold needs."""
    registry = StorageRegistry(pev_config(tmp_path))
    app_id = registry.get_meta_data_apps().insert(App(0, "streamapp"))
    registry.get_meta_data_access_keys().insert(AccessKey("SK", app_id, ()))
    events = registry.get_events()
    events.init(app_id)
    _seed_ratings(events, app_id)
    ctx = RuntimeContext(registry=registry, device="cpu")
    engine = rec.RecommendationEngine.apply()
    params = engine.engine_params_from_variant({
        "datasource": {"params": {"app_name": "streamapp"}},
        "algorithms": [{"name": "als", "params": PARAMS}]})
    row = CoreWorkflow.run_train(engine, params, ctx)
    yield registry, engine, params, row, app_id
    registry.close()


def _cols_rows(cols):
    """The order-free row multiset of an EventColumns."""
    return sorted(
        (cols.entities[int(e)], cols.targets[int(t)], float(v), int(us))
        for e, t, v, us in zip(cols.entity_ix, cols.target_ix,
                               cols.value, cols.t_us))


# -- the delta scan --------------------------------------------------------------

def test_delta_equals_tail_of_full_scan(trained_pev):
    registry, _, _, _, app_id = trained_pev
    events = registry.get_events()
    wm1 = events.ingest_watermark(app_id)
    before = _cols_rows(events.scan_columns(app_id, **SPEC))
    events.insert_batch(
        [_rate("u1", "i4", 5.0), _rate("u30", "i2", 3.0)], app_id)
    wm2 = events.ingest_watermark(app_id)
    assert wm2 != wm1
    delta = events.scan_columns(app_id, since=wm1, upto=wm2, **SPEC)
    assert events.scan_columns(app_id, since=wm1, upto=wm1, **SPEC).n == 0
    assert delta.n == 2 and set(delta.entities) == {"u1", "u30"}
    # full == snapshot + delta, row for row
    assert _cols_rows(events.scan_columns(app_id, **SPEC)) == sorted(
        before + _cols_rows(delta))


def _tombstone(events, app_id, tmp):
    victim = next(iter(events.find(app_id, event_names=["rate"], limit=1)))
    assert events.delete(victim.event_id, app_id)


def _external_id(events, app_id, tmp):
    events.insert(_rate("u2", "i1", 2.0).with_id("caller-supplied"), app_id)


def _rewritten_segment(events, app_id, tmp):
    seg = sorted((tmp / "pevlog").glob("app_*/seg_*.log"))[0]
    with open(seg, "r+b") as f:       # shorter than before the insert
        f.truncate(seg.stat().st_size - 2000)


@pytest.mark.parametrize("cause,write,match", [
    ("tombstone", _tombstone, "tombstones.log changed"),
    ("external_id", _external_id, "external_ids.log changed"),
    ("rewritten_segment", _rewritten_segment, "rewritten"),
])
def test_history_rewrites_invalidate_the_delta(trained_pev, tmp_path, cause,
                                               write, match):
    """A delete, a caller-supplied id (last-wins overwrite) or a shrunk
    segment between the watermarks means rows already folded may be
    dead or double-counted: the delta refuses and the full scan stays
    ground truth."""
    registry, _, _, _, app_id = trained_pev
    events = registry.get_events()
    wm1 = events.ingest_watermark(app_id)
    write(events, app_id, tmp_path)
    events.insert(_rate("u1", "i4", 5.0), app_id)
    wm2 = events.ingest_watermark(app_id)
    with pytest.raises(DeltaInvalidated, match=match):
        events.scan_columns(app_id, since=wm1, upto=wm2, **SPEC)
    if cause != "rewritten_segment":
        assert events.scan_columns(app_id, **SPEC).n == sum(
            1 for _ in events.find(app_id, event_names=["rate"]))


def test_byte_budget_invalidates(trained_pev, monkeypatch):
    registry, _, _, _, app_id = trained_pev
    events = registry.get_events()
    wm1 = events.ingest_watermark(app_id)
    events.insert_batch([_rate("u1", f"i{i}", 2.0) for i in range(9)],
                        app_id)
    wm2 = events.ingest_watermark(app_id)
    assert events.scan_columns(app_id, since=wm1, upto=wm2, **SPEC).n == 9
    monkeypatch.setenv("PIO_DELTA_MAX_BYTES", "16")
    with pytest.raises(DeltaInvalidated, match="PIO_DELTA_MAX_BYTES"):
        events.scan_columns(app_id, since=wm1, upto=wm2, **SPEC)


@pytest.mark.parametrize("kind", ["MEM", "SQLITE"])
def test_drivers_without_a_delta_path(kind, tmp_path):
    config = ({"PIO_STORAGE_SOURCES_M_TYPE": "MEM"} if kind == "MEM" else
              {"PIO_STORAGE_SOURCES_S_TYPE": "SQLITE",
               "PIO_STORAGE_SOURCES_S_PATH": str(tmp_path / "x.db")})
    events = StorageRegistry(config).get_events()
    events.init(1)
    events.insert(_rate("u0", "i0", 5.0), 1)
    with pytest.raises(DeltaInvalidated, match="no delta"):
        events.scan_columns(1, since={}, upto={}, **SPEC)


def test_scan_delta_summary_and_touched_cap(trained_pev, monkeypatch):
    registry, _, _, _, app_id = trained_pev
    events = registry.get_events()
    wm1 = events.ingest_watermark(app_id)
    events.insert_batch(
        [_rate("u1", "i4", 5.0), _rate("u2", "i5", 4.0)], app_id)
    wm2 = events.ingest_watermark(app_id)
    d = scan_delta(events, app_id, None, wm1, wm2)
    assert not d.empty and d.n_events == 2
    assert set(d.touched_users) == {"u1", "u2"}
    assert set(d.touched_items) == {"i4", "i5"}
    assert d.newest_us > 0
    assert scan_delta(events, app_id, None, wm2, wm2).empty
    monkeypatch.setenv("PIO_FOLD_MAX_TOUCHED", "1")
    with pytest.raises(DeltaInvalidated, match="PIO_FOLD_MAX_TOUCHED"):
        scan_delta(events, app_id, None, wm1, wm2)


def test_delta_dataclass_empty_flag():
    assert Delta({}, {}, (), (), 0, 0).empty
    assert not Delta({}, {}, ("u",), ("i",), 1, 5).empty


HISTORY = dict(entity_type="user", event_names=["rate", "buy"],
               value_spec={"rate": ("prop", "rating"), "buy": 4.0},
               require_target=True)


def _same_columns(a, b):
    for f in ("entity_ix", "target_ix", "value", "t_us"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (a.entities, a.targets) == (b.entities, b.targets)


def test_history_extended_by_the_delta_equals_a_full_scan(trained_pev):
    """The cached history at `since` merged with the delta is the full
    scan at `upto`, column for column and table for table, with events
    tied in time with older ones, a new user, a repeated pair and a
    foreign event in the delta."""
    registry, _, _, _, app_id = trained_pev
    events = registry.get_events()
    cache = {}
    wm0 = events.ingest_watermark(app_id)

    def fctx(since, upto):
        return FoldContext(store=events, app_id=app_id, channel_id=None,
                           since=since, upto=upto, history_cache=cache)

    first = fctx({}, wm0).history_columns(**HISTORY)   # a miss: a scan
    _same_columns(first, events.scan_columns(app_id, **HISTORY))
    assert [v[0] for v in cache.values()] == [wm0]
    t_old = next(iter(events.find(app_id, limit=1))).event_time
    events.insert_batch([
        Event("rate", "user", "u1", "item", "i2", DataMap({"rating": 2.0}),
              t_old),
        _rate("newbie", "i3", 4.0), _rate("u1", "i2", 5.0),
        Event("buy", "user", "u5", "item", "i1"),
        Event("view", "user", "u5", "item", "i1")], app_id)
    wm1 = events.ingest_watermark(app_id)
    scans = []
    real = events.scan_columns

    def spy(*a, **kw):
        scans.append(kw.get("since"))
        return real(*a, **kw)

    events.scan_columns = spy
    try:
        merged = fctx(wm0, wm1).history_columns(**HISTORY)
    finally:
        del events.scan_columns
    assert scans == [wm0]                  # the delta only, no full scan
    _same_columns(merged, events.scan_columns(app_id, **HISTORY))
    assert merged.n == first.n + 4 and cache[next(iter(cache))][0] == wm1


def test_history_scanned_while_the_journal_moved_is_not_cached(trained_pev):
    registry, _, _, _, app_id = trained_pev
    events = registry.get_events()
    cache = {}
    wm0 = events.ingest_watermark(app_id)
    real = events.scan_columns

    def racing(*a, **kw):
        out = real(*a, **kw)
        events.insert(_rate("u2", "i2", 3.0), app_id)
        return out

    events.scan_columns = racing
    try:
        FoldContext(store=events, app_id=app_id, channel_id=None, since={},
                    upto=wm0, history_cache=cache).history_columns(
                        **HISTORY)
    finally:
        del events.scan_columns
    assert cache == {}


# -- fold_in_rows ----------------------------------------------------------------

def _fold(y, hists, **kw):
    return als.fold_in_rows(y, hists, device="cpu", **kw).numpy()


def test_explicit_matches_normal_equations():
    rng = np.random.default_rng(0)
    y = rng.normal(size=(16, 4)).astype(np.float32)
    reg = 0.07
    hists = [(np.array([1, 3, 5], np.int32),
              np.array([5.0, 1.0, 4.0], np.float32)),
             (np.array([2], np.int32), np.array([3.0], np.float32))]
    rows = _fold(y, hists, reg=reg)
    assert rows.shape == (2, 4)
    for r, (ix, v) in enumerate(hists):
        yh = y[ix]
        a = yh.T @ yh + reg * len(ix) * np.eye(4, dtype=np.float32)
        np.testing.assert_allclose(rows[r], np.linalg.solve(a, yh.T @ v),
                                   atol=1e-4)


def test_implicit_matches_confidence_weighting():
    rng = np.random.default_rng(1)
    y = rng.normal(size=(12, 4)).astype(np.float32)
    reg, alpha = 0.05, 2.0
    ix = np.array([0, 4, 7], np.int32)
    v = np.array([1.0, 1.0, 3.0], np.float32)
    rows = _fold(y, [(ix, v)], reg=reg, implicit=True, alpha=alpha)
    yh = y[ix]
    conf = alpha * np.abs(v)                      # c - 1
    a = (yh.T * conf) @ yh + y.T @ y \
        + reg * len(ix) * np.eye(4, dtype=np.float32)
    np.testing.assert_allclose(rows[0], np.linalg.solve(a, yh.T @ (1 + conf)),
                               atol=1e-4)


def test_empty_histories():
    y = np.ones((4, 3), np.float32)
    assert _fold(y, [], reg=0.1).shape == (0, 3)
    out = _fold(y, [(np.zeros(0, np.int32), np.zeros(0, np.float32))],
                reg=0.1)
    assert out.shape == (1, 3) and not out.any()


def _histories(rng, n_opp, lens):
    return [(rng.choice(n_opp, size=n, replace=False).astype(np.int32),
             rng.integers(1, 6, size=n).astype(np.float32)) for n in lens]


@pytest.mark.parametrize("rank,reg,implicit,tol", [
    (4, 0.07, False, 5e-5), (16, 0.07, False, 5e-5), (4, 0.07, True, 5e-5),
    (16, 0.05, True, 5e-5), (64, 0.5, False, 1e-5), (64, 0.5, True, 1e-5),
])
def test_fold_in_rows_matches_the_jax_package(rank, reg, implicit, tol):
    """Cholesky (rank <= 16) and CG from zero, min(32, rank + 8) steps
    (rank 64, a well-conditioned system, so both CGs converge) against
    the JAX `fold_in_rows` on the same inputs."""
    rng = np.random.default_rng(rank)
    y = rng.normal(size=(300, rank)).astype(np.float32)
    hists = _histories(rng, 300, (3, 1, 0, 50, 120, 7, 200))
    got = _fold(y, hists, reg=reg, implicit=implicit, alpha=2.0)
    want = np.asarray(jals.fold_in_rows(y, hists, reg=reg,
                                        implicit=implicit, alpha=2.0))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("rank", [4, 64])
def test_a_row_does_not_depend_on_the_other_rows(rank):
    """The port pads no batch to a power of two: a row solved alone and
    beside others of other degrees comes out bit-identical."""
    rng = np.random.default_rng(3)
    y = rng.normal(size=(200, rank)).astype(np.float32)
    hists = _histories(rng, 200, (9, 40, 9, 130))
    together = _fold(y, hists, reg=0.3)
    for r, h in enumerate(hists):
        np.testing.assert_array_equal(_fold(y, [h], reg=0.3)[0], together[r])


def test_long_histories_keep_their_newest_events(monkeypatch):
    rng = np.random.default_rng(4)
    y = rng.normal(size=(50, 4)).astype(np.float32)
    ix = rng.choice(50, size=10, replace=False).astype(np.int32)
    v = rng.integers(1, 6, size=10).astype(np.float32)
    monkeypatch.setattr(als, "_FOLD_HISTORY_CAP", 4)
    np.testing.assert_array_equal(_fold(y, [(ix, v)], reg=0.2),
                                  _fold(y, [(ix[-4:], v[-4:])], reg=0.2))


def test_fold_runs_where_asked_and_never_on_the_cpu_unasked(monkeypatch):
    """The solve runs on `device`, else on the opposite tensor's, else on
    cuda, which raises without a card: no CPU carry-on."""
    y = torch.randn(30, 4)
    hist = [(np.array([1, 2], np.int32), np.array([4.0, 2.0], np.float32))]
    out = als.fold_in_rows(y, hist, reg=0.1)
    assert out.device.type == "cpu" and out.dtype == torch.float32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        als.fold_in_rows(y.numpy(), hist, reg=0.1)


@pytest.mark.parametrize("dedup", [True, False])
def test_histories_match_the_jax_history_arrays(dedup):
    """The vectorized grouping gives, per touched key, the JAX package's
    `_history_arrays` over that key's `find` events: repeated pairs
    (last value at the first place), ties in time, a key with no rows;
    an unknown opposite id raises at the key's first one."""
    from datetime import datetime, timedelta, timezone
    from predictionio_tpu.streaming.updaters import _history_arrays
    from predictionio_tpu_torch.data.storage import columns
    from predictionio_tpu_torch.streaming.updaters import _histories
    rng = np.random.default_rng(5)
    t0 = datetime(2024, 1, 1, tzinfo=timezone.utc)
    rows = sorted(((f"u{rng.integers(0, 6)}", f"i{rng.integers(0, 9)}",
                    float(rng.integers(1, 6)), int(rng.integers(0, 40)))
                   for _ in range(300)), key=lambda r: r[3])
    items = BiMap.from_keys(f"i{n}" for n in range(9))
    cols = columns.columns_from_events(
        [Event("rate", "user", u, "item", i, DataMap({"rating": v}),
               t0 + timedelta(seconds=t)) for u, i, v, t in rows],
        {"rate": ("prop", "rating")})
    keys = ["u3", "u0", "u5", "nobody"]

    def hist(keys, opp_map):
        return _histories(keys, cols.entity_ix, cols.entities,
                          cols.target_ix, cols.targets, opp_map, cols.value,
                          dedup, lambda k, o: f"{k} {o}")

    for key, (ix, val) in zip(keys, hist(keys, items)):
        evs = [JEvent("rate", "user", u, "item", i, JDataMap({"rating": v}),
                      t0 + timedelta(seconds=t))
               for u, i, v, t in rows if u == key]
        want = _history_arrays(evs, lambda e: items.get(e.target_entity_id),
                               lambda e: e.properties.get("rating"), dedup)
        np.testing.assert_array_equal(ix, want[0])
        np.testing.assert_array_equal(val, want[1])
        assert ix.dtype == want[0].dtype and val.dtype == want[1].dtype
    first = next(i for u, i, _, _ in rows if u == "u3")
    with pytest.raises(DeltaInvalidated, match=f"u3 {first}$"):
        hist(["u3"], BiMap.from_keys(k for k in items.keys() if k != first))


def test_extend_bimap_is_stable():
    base = BiMap.from_keys(["a", "b"])
    ext = extend_bimap(base, ["b", "c", "c", "d"])
    assert ext.get("a") == base.get("a") and ext.get("b") == base.get("b")
    assert ext.get("c") == 2 and ext.get("d") == 3
    assert extend_bimap(base, ["a"]) is base


# -- the template's fold_in --------------------------------------------------------

def _fold_fixture(trained_pev):
    registry, engine, params, _, app_id = trained_pev
    ctx = RuntimeContext(registry=registry, device="cpu")
    ds, prep, algos, _ = engine.make_components(params)
    pd = prep.prepare(ctx, ds.read_training(ctx))
    model = algos[0].train(ctx, pd)
    events = registry.get_events()

    def fold(batch, on=None):
        wm1 = events.ingest_watermark(app_id)
        events.insert_batch(batch, app_id)
        wm2 = events.ingest_watermark(app_id)
        delta = scan_delta(events, app_id, None, wm1, wm2)
        fctx = FoldContext(store=events, app_id=app_id, channel_id=None,
                           since=wm1, upto=wm2,
                           ds_params={"app_name": "streamapp"})
        return algos[0].fold_in(on or model, delta, fctx), (wm1, wm2, delta)

    return ctx, (ds, prep, algos), model, events, app_id, fold


def test_untouched_rows_bit_identical_touched_reranked(trained_pev):
    ctx, comps, model, events, app_id, fold = _fold_fixture(trained_pev)
    loved = ["i2", "i5", "i8"]             # u1 turns to the i % 3 == 2 cluster
    folded, _ = fold([_rate("u1", it, 5.0) for it in loved])
    u1 = model.users.get("u1")
    touched = {model.items.get(it) for it in loved}
    keep_u = [i for i in range(len(model.users)) if i != u1]
    keep_i = [i for i in range(len(model.items)) if i not in touched]
    assert torch.equal(folded.user_factors[keep_u],
                       model.user_factors[keep_u])
    assert torch.equal(folded.item_factors[keep_i],
                       model.item_factors[keep_i])
    assert not torch.equal(folded.user_factors[u1], model.user_factors[u1])
    scores = folded.user_factors[u1] @ folded.item_factors.T
    assert {int(i) for i in torch.argsort(-scores)[:3]} & touched


def test_topk_parity_vs_full_retrain(trained_pev):
    ctx, (ds, prep, algos), model, events, app_id, fold = \
        _fold_fixture(trained_pev)
    folded, _ = fold([_rate("u1", "i2", 5.0), _rate("u1", "i5", 5.0)])
    model2 = algos[0].train(ctx, prep.prepare(ctx, ds.read_training(ctx)))
    sf = folded.user_factors[folded.users.get("u1")] @ folded.item_factors.T
    sr = model2.user_factors[model2.users.get("u1")] @ model2.item_factors.T
    top_f = {folded.items.keys()[int(i)] for i in torch.argsort(-sf)[:5]}
    top_r = {model2.items.keys()[int(i)] for i in torch.argsort(-sr)[:5]}
    assert len(top_f & top_r) >= 3, (top_f, top_r)


def test_refold_deterministic_no_double_count(trained_pev):
    """Touched rows are re-solved from their FULL history: the fold is a
    pure function of (model, store), and folding its own output again
    leaves every untouched row bit-identical."""
    ctx, (_, _, algos), model, events, app_id, fold = \
        _fold_fixture(trained_pev)
    once_a, (wm1, wm2, delta) = fold([_rate("u1", "i2", 5.0)])
    fctx = FoldContext(store=events, app_id=app_id, channel_id=None,
                       since=wm1, upto=wm2,
                       ds_params={"app_name": "streamapp"})
    once_b = algos[0].fold_in(model, delta, fctx)
    assert torch.equal(once_a.user_factors, once_b.user_factors)
    assert torch.equal(once_a.item_factors, once_b.item_factors)
    twice = algos[0].fold_in(once_a, delta, fctx)
    u1, i2 = model.users.get("u1"), model.items.get("i2")
    keep_u = [i for i in range(len(model.users)) if i != u1]
    keep_i = [i for i in range(len(model.items)) if i != i2]
    assert torch.equal(twice.user_factors[keep_u], model.user_factors[keep_u])
    assert torch.equal(twice.item_factors[keep_i], model.item_factors[keep_i])


def test_new_user_extends_new_item_invalidates(trained_pev):
    ctx, comps, model, events, app_id, fold = _fold_fixture(trained_pev)
    folded, _ = fold([_rate("fresh-user", "i2", 5.0)])
    assert folded.users.get("fresh-user") == len(model.users)
    assert folded.user_factors.shape[0] == len(folded.users)
    assert torch.equal(folded.user_factors[:len(model.users)],
                       model.user_factors)
    with pytest.raises(DeltaInvalidated, match="unknown item 'i-new'"):
        fold([_rate("u1", "i-new", 5.0)])


def test_foreign_events_fold_nothing(trained_pev):
    ctx, comps, model, events, app_id, fold = _fold_fixture(trained_pev)
    folded, _ = fold([Event("view", "user", "u1", "item", "i2")])
    assert folded is None


def test_template_fold_in_agrees_with_the_jax_template(trained_pev,
                                                       tmp_path):
    """The same trained factors, the same store (the JAX package reads
    the port's PEVLOG directory and sqlite file), the same drip: the
    touched rows of both folds agree within 1e-4 (rank 4, Cholesky) and
    every untouched row is the trained one in both."""
    registry, engine, params, row, app_id = trained_pev
    ctx, (_, _, algos), model, events, _, fold = _fold_fixture(trained_pev)
    drip = [("u1", "i2", 5.0), ("u4", "i7", 1.0), ("newbie", "i3", 4.0),
            ("u1", "i2", 2.0)]             # the last rating of a pair wins
    folded, (wm1, wm2, _) = fold([_rate(*d) for d in drip])
    jreg = JRegistry(pev_config(tmp_path))
    jevents = jreg.get_events()
    assert jevents.ingest_watermark(app_id) == wm2
    jmodel = jals.ALSModel(model.user_factors.numpy(),
                           model.item_factors.numpy(),
                           JBiMap.from_keys(model.users.keys()),
                           JBiMap.from_keys(model.items.keys()))
    jalgo = jrec.ALSAlgorithm(jrec.ALSAlgorithmParams(**PARAMS))
    jdelta = jscan_delta(jevents, app_id, None, wm1, wm2)
    jfolded = jalgo.fold_in(jmodel, jdelta, JFoldContext(
        store=jevents, app_id=app_id, channel_id=None, since=wm1,
        upto=wm2, ds_params={"app_name": "streamapp"}))
    assert jfolded.users.keys() == folded.users.keys()
    np.testing.assert_allclose(folded.user_factors.numpy(),
                               jfolded.user_factors, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(folded.item_factors.numpy(),
                               jfolded.item_factors, rtol=1e-4, atol=1e-4)
    touched_u = {folded.users.get(u) for u, _, _ in drip}
    for ix in range(len(model.users)):
        if ix not in touched_u:
            np.testing.assert_array_equal(jfolded.user_factors[ix],
                                          folded.user_factors[ix].numpy())
    jreg.close()


# -- the refresher on a live server --------------------------------------------

def call(port, method, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


@pytest.fixture()
def served(trained_pev):
    registry, engine, _, row, app_id = trained_pev
    ctx = RuntimeContext(registry=registry, device="cpu")
    srv = cli_main.deploy_instance(engine, row, ctx, port=0, batch_max=4)
    yield registry, srv, app_id
    srv.stop()


def _plan_state(srv):
    plan = srv.deployment.algos[0]._serve_plan
    return plan, plan.calls, frozenset(plan._warm)


def test_tick_protocol_and_hot_swap_without_rewarm(served):
    registry, srv, app_id = served
    events = registry.get_events()
    assert srv._refresher is None          # off by default
    r = Refresher(srv, interval_s=999.0)   # manual ticks only
    assert r.tick() == "baseline"
    assert r.tick() == "noop"
    status, body = call(srv.port, "POST", "/queries.json",
                        {"user": "fresh-user", "num": 3})
    assert status == 200 and body["itemScores"] == []
    events.insert_batch(
        [_rate("fresh-user", it, 5.0) for it in ("i2", "i5")], app_id)
    old = srv.deployment
    plan, calls, warm = _plan_state(srv)
    assert r.tick() == "folded"
    # the same warmed plan, no launch: the swap only rebinds its factors
    assert _plan_state(srv) == (plan, calls, warm)
    assert srv.deployment is not old and srv.deployment.instance is \
        old.instance and srv.deployment.algos == old.algos
    assert torch.equal(plan.factors, srv.deployment.models[0].item_factors)
    status, body = call(srv.port, "POST", "/queries.json",
                        {"user": "fresh-user", "num": 3})
    assert status == 200 and len(body["itemScores"]) == 3
    assert 0.0 <= r.freshness_s < 120.0
    assert {"scan_s", "fold_s", "swap_s", "publish_s", "seconds"} <= set(
        r.last_ticks["folded"])
    assert r.status()["watermark"] == registry.get_events().ingest_watermark(
        app_id)
    assert r.tick() == "noop"              # the watermark advanced
    assert r.ticks == {"baseline": 1, "noop": 2, "folded": 1}


def test_reload_rebases_the_refresher_and_drops_a_superseded_fold(served):
    """A /reload publishes a deployment of another load: the refresher's
    next tick is a new baseline, and a fold computed from the replaced
    deployment is not published (its factor swap undone)."""
    registry, srv, app_id = served
    events = registry.get_events()
    r = Refresher(srv, interval_s=999.0)
    srv._refresher = r                     # what reload() rebases
    assert r.tick() == "baseline"
    assert r.tick() == "noop"
    assert call(srv.port, "POST", "/reload")[0] == 200
    assert r.tick() == "baseline"          # rebased on the new load
    events.insert_batch([_rate("u1", "i2", 5.0)], app_id)
    stale = srv.deployment
    srv.publish(srv._refresh_deployment(stale, stale.models))
    plan = stale.algos[0]._serve_plan
    before = plan.factors
    assert r._fold_and_swap(stale, scan_delta(
        events, app_id, None, r._wm, events.ingest_watermark(app_id)),
        FoldContext(store=events, app_id=app_id, channel_id=None,
                    since=r._wm, upto=events.ingest_watermark(app_id),
                    ds_params={"app_name": "streamapp"}), {}) == \
        "superseded"
    assert plan.factors is before and srv.deployment is not stale
    srv._refresher = None


def test_second_fold_extends_the_cached_history(served):
    """The refresher's second fold reads the delta alone (its history is
    the first fold's extended), and serves the model that two folds
    without a cache give, bit for bit."""
    registry, srv, app_id = served
    events = registry.get_events()
    model0 = srv.deployment.models[0]
    algo = srv.deployment.algos[0]
    r = Refresher(srv, interval_s=999.0)
    assert r.tick() == "baseline"
    own = model0
    for drip in ([_rate("u1", "i2", 5.0), _rate("u3", "i4", 1.0)],
                 [_rate("u1", "i5", 4.0), _rate("fresh", "i2", 2.0)]):
        wm1 = events.ingest_watermark(app_id)
        events.insert_batch(drip, app_id)
        wm2 = events.ingest_watermark(app_id)
        full = []
        real = events.scan_columns

        def spy(*a, **kw):
            full.append(kw.get("since") is None)
            return real(*a, **kw)

        events.scan_columns = spy
        try:
            assert r.tick() == "folded"
        finally:
            del events.scan_columns
        own = algo.fold_in(own, scan_delta(events, app_id, None, wm1, wm2),
                           FoldContext(store=events, app_id=app_id,
                                       channel_id=None, since=wm1, upto=wm2,
                                       ds_params={"app_name": "streamapp"}))
        served_model = srv.deployment.models[0]
        assert torch.equal(served_model.user_factors, own.user_factors)
        assert torch.equal(served_model.item_factors, own.item_factors)
    assert full == [False, False, False]   # delta, template delta, history
    assert r.ticks["folded"] == 2
    assert r.last_ticks["folded"]["history_scans"] == 0


def test_delete_forces_full_rebuild_with_the_plan_swapped(served):
    registry, srv, app_id = served
    events = registry.get_events()
    r = Refresher(srv, interval_s=999.0)
    assert r.tick() == "baseline"
    victim = next(iter(events.find(app_id, event_names=["rate"], limit=1)))
    assert events.delete(victim.event_id, app_id)
    plan, calls, warm = _plan_state(srv)
    assert r.tick() == "full_rebuild"
    assert _plan_state(srv) == (plan, calls, warm)   # same shape: swapped
    status, body = call(srv.port, "POST", "/queries.json",
                        {"user": "u1", "num": 3})
    assert status == 200 and len(body["itemScores"]) == 3
    assert r.tick() == "noop"


def test_new_item_forces_full_rebuild_and_rewarm(served):
    registry, srv, app_id = served
    events = registry.get_events()
    r = Refresher(srv, interval_s=999.0)
    assert r.tick() == "baseline"
    events.insert(_rate("u1", "i-new", 5.0), app_id)
    plan, _, _ = _plan_state(srv)
    assert r.tick() == "full_rebuild"
    new_plan = srv.deployment.algos[0]._serve_plan
    assert new_plan is not plan and new_plan.n_items == plan.n_items + 1
    assert srv.deployment.models[0].items.get("i-new") is not None
    status, body = call(srv.port, "POST", "/queries.json",
                        {"user": "u1", "num": 3})
    assert status == 200 and len(body["itemScores"]) == 3


def test_outcomes_without_an_app_or_a_watermark(served, tmp_path):
    registry, srv, app_id = served
    dep = srv.deployment
    r = Refresher(srv, interval_s=999.0)
    srv.deployment = None
    assert r.tick() == "no_deployment"
    srv.deployment = dep
    srv.publish(cli_main._Deployment(dep.algos, dep.models, dep.serving))
    assert r.tick() == "no_app"            # a model in hand: no instance
    srv.publish(dep)
    mem = StorageRegistry({"PIO_STORAGE_SOURCES_M_TYPE": "MEM"})
    mem.get_meta_data_apps().insert(App(app_id, "streamapp"))
    srv.ctx = RuntimeContext(registry=mem, device="cpu")
    assert r.tick() == "no_watermark"
    assert r.ticks == {"no_deployment": 1, "no_app": 1, "no_watermark": 1}


def test_foreign_events_give_no_hooks_and_a_raising_tick_counts_failed(
        served, monkeypatch):
    """A delta of events no template folds (views with a target) is
    `no_hooks`, with the watermark advanced; a tick that raises is
    counted `failed` by the loop, which keeps ticking."""
    registry, srv, app_id = served
    events = registry.get_events()
    r = Refresher(srv, interval_s=0.01)
    assert r.tick() == "baseline"
    events.insert(Event("view", "user", "u1", "item", "i2"), app_id)
    assert r.tick() == "no_hooks"
    assert r.tick() == "noop"

    def broken(dep, registry):
        raise OSError("store unreachable")

    monkeypatch.setattr(
        "predictionio_tpu_torch.streaming.refresher.locate_event_store",
        broken)
    r.start()
    try:
        for _ in range(500):
            if r.ticks.get("failed", 0) >= 2:
                break
            r._stop.wait(0.01)
    finally:
        r.stop()
    assert r.ticks["failed"] >= 2 and not r._thread.is_alive()


def test_stagger_delays_first_tick(served):
    _, srv, _ = served
    r = Refresher(srv, interval_s=999.0, stagger_s=999.0)
    r.start()
    try:
        assert r.last_outcome == ""        # still inside the stagger
    finally:
        r.stop()
    assert not r._thread.is_alive()


def test_server_runs_and_stops_the_refresher_and_shows_it(trained_pev):
    registry, engine, _, row, app_id = trained_pev
    ctx = RuntimeContext(registry=registry, device="cpu")
    srv = cli_main.deploy_instance(engine, row, ctx, port=0, batch_max=2,
                                   refresh_interval_s=0.05)
    try:
        r = srv._refresher
        assert r is not None and r.interval_s == 0.05
        deadline = threading.Event()
        while not r.ticks.get("baseline") and not deadline.wait(0.02):
            pass
        registry.get_events().insert(_rate("u3", "i4", 5.0), app_id)
        for _ in range(500):
            if r.ticks.get("folded"):
                break
            deadline.wait(0.02)
        status, body = call(srv.port, "GET", "/")
        assert status == 200 and body["refresh"]["ticks"]["folded"] == 1
        assert body["refresh"]["ticks"]["baseline"] == 1
        assert body["refresh"]["freshness_s"] >= 0.0
    finally:
        srv.stop()
    assert r._stop.is_set() and not r._thread.is_alive()


def test_cli_deploy_takes_refresh_interval():
    args = cli_main.build_parser().parse_args(
        ["deploy", "--refresh-interval", "2.5"])
    assert args.refresh_interval == 2.5
    assert cli_main.build_parser().parse_args(
        ["deploy"]).refresh_interval == 0.0


def test_swap_failure_rolls_back_with_zero_failed_requests(served,
                                                           monkeypatch):
    """`swap_factors` raises on its first call, mid-commit: the tick
    reports rolled_back, the last good model keeps serving while clients
    hammer the server, the watermark stays, and the next tick lands the
    same delta."""
    registry, srv, app_id = served
    events = registry.get_events()
    r = Refresher(srv, interval_s=999.0)
    assert r.tick() == "baseline"
    baseline = dict(r._wm)
    events.insert_batch(
        [_rate("fresh-user", it, 5.0) for it in ("i2", "i5")], app_id)
    plan = srv.deployment.algos[0]._serve_plan
    real = plan.swap_factors
    attempts = []

    def flaky(factors):
        attempts.append(factors)
        if len(attempts) == 1:
            raise RuntimeError("injected swap failure")
        return real(factors)

    monkeypatch.setattr(plan, "swap_factors", flaky)
    before = plan.factors
    failures, stop = [], threading.Event()

    def hammer():
        while not stop.is_set():
            status, _ = call(srv.port, "POST", "/queries.json",
                             {"user": "u1", "num": 3})
            if status != 200:
                failures.append(status)

    threads = [threading.Thread(target=hammer, name=f"hammer-{n}")
               for n in range(3)]
    for t in threads:
        t.start()
    try:
        old = srv.deployment
        assert r.tick() == "rolled_back"
        assert srv.deployment is old and plan.factors is before
        assert r._wm == baseline
        assert r.tick() == "folded"
    finally:
        stop.set()
        for t in threads:
            t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert not failures
    status, body = call(srv.port, "POST", "/queries.json",
                        {"user": "fresh-user", "num": 3})
    assert status == 200 and len(body["itemScores"]) == 3
    assert r.ticks["rolled_back"] == 1


def test_jax_trained_store_events_fold_in_the_port(tmp_path):
    """Events the JAX package wrote into PEVLOG fold in the port: a
    JAX-written journal is a delta source like the port's own."""
    jreg = JRegistry(pev_config(tmp_path))
    app_id = jreg.get_meta_data_apps().insert(JApp(0, "streamapp"))
    jevents = jreg.get_events()
    jevents.init(app_id)
    _seed_ratings(jevents, app_id)
    jreg.close()
    registry = StorageRegistry(pev_config(tmp_path))
    ctx = RuntimeContext(registry=registry, device="cpu")
    engine = rec.RecommendationEngine.apply()
    params = engine.engine_params_from_variant({
        "datasource": {"params": {"app_name": "streamapp"}},
        "algorithms": [{"name": "als", "params": PARAMS}]})
    row = CoreWorkflow.run_train(engine, params, ctx)
    srv = cli_main.deploy_instance(engine, row, ctx, port=0, batch_max=2)
    try:
        r = Refresher(srv, interval_s=999.0)
        assert r.tick() == "baseline"
        jreg = JRegistry(pev_config(tmp_path))
        jreg.get_events().insert_batch(
            [_rate("u1", "i2", 5.0, (JEvent, JDataMap))], app_id)
        jreg.close()
        assert r.tick() == "folded"
    finally:
        srv.stop()
        registry.close()
