"""The port's property aggregation (`predictionio_tpu_torch.data.
aggregate`, `EventStore.aggregate_properties`, PEVLOG's raw-frame form)
against the JAX package's.

Every case of `tests/test_aggregate.py` runs through both `aggregate.py`
modules on the same events, and the two results must be EQUAL (fields,
first and last update times), beside the case's own assertion on the
port. Then the stores: `aggregate_properties` must give the same map on
the port's MEM, SQLITE and PEVLOG drivers (PEVLOG on its raw path and on
the base fallback an external event id forces) as the JAX MEM store on
the same events, and a PEVLOG directory the JAX package wrote must
aggregate the same in the port. Exact equality throughout: aggregation
has no arithmetic to round."""

import random
from datetime import datetime, timedelta, timezone

import pytest

from predictionio_tpu.data import event as jev
from predictionio_tpu.data import aggregate as jagg
from predictionio_tpu.data.storage.memory import (
    MemEvents as JMemEvents, MemStorageClient as JMemClient)
from predictionio_tpu.data.storage.pevlog import (
    PevlogEvents as JPevlogEvents, PevlogStorageClient as JPevlogClient)
from predictionio_tpu_torch.data import aggregate as pagg
from predictionio_tpu_torch.data import event as pev
from predictionio_tpu_torch.data.storage.memory import (MemEvents,
                                                        MemStorageClient)
from predictionio_tpu_torch.data.storage.pevlog import (PevlogEvents,
                                                        PevlogStorageClient)
from predictionio_tpu_torch.data.storage.sqlite import (SQLiteEvents,
                                                        SQLiteStorageClient)

pytestmark = pytest.mark.torch

T0 = datetime(2020, 1, 1, tzinfo=timezone.utc)


def at(minutes):
    return T0 + timedelta(minutes=minutes)


# an event as (kind, entity id, keys or fields, minutes)
def set_(eid, props, t):
    return ("$set", eid, props, t)


def unset(eid, keys, t):
    return ("$unset", eid, {k: None for k in keys}, t)


def delete(eid, t):
    return ("$delete", eid, None, t)


def plain(eid, t):
    return ("view", eid, None, t)


def build(mod, spec, entity_type="user", **kw):
    """The events of `spec` as `mod`'s Event objects (`mod` is the event
    module of one package)."""
    out = []
    for name, eid, props, t in spec:
        out.append(mod.Event(event=name, entity_type=entity_type,
                             entity_id=eid,
                             properties=mod.DataMap(props or {}),
                             event_time=at(t), **kw))
    return out


def norm(result):
    """An aggregate result as plain data: entity -> (fields, first,
    last); None stays None."""
    if result is None:
        return None
    if not isinstance(result, dict):
        return (dict(result.fields.fields), result.first_updated,
                result.last_updated)
    return {k: norm(v) for k, v in result.items()}


def both(spec):
    """aggregate_properties of `spec` through both modules; asserts they
    agree and returns the port's result."""
    j = jagg.aggregate_properties(build(jev, spec))
    p = pagg.aggregate_properties(build(pev, spec))
    assert norm(p) == norm(j)
    return p


CASES = {
    "last_write_wins": [set_("u1", {"a": 1, "b": 1}, 0),
                        set_("u1", {"a": 2}, 10),
                        set_("u1", {"b": 0}, 5)],
    "unset_removes_only_older_sets": [set_("u1", {"a": 1, "b": 1}, 0),
                                      unset("u1", ["a"], 5),
                                      set_("u1", {"a": 3}, 10)],
    "unset_wins_tie_with_set": [set_("u1", {"a": 1}, 5),
                                unset("u1", ["a"], 5)],
    "unset_tie_leaves_remaining_fields": [set_("u1", {"a": 1, "b": 2}, 5),
                                          unset("u1", ["a"], 5)],
    "delete_removes_entity": [set_("u1", {"a": 1}, 0), delete("u1", 5)],
    "delete_tie_wins_over_set": [set_("u1", {"a": 1}, 5), delete("u1", 5)],
    "set_after_delete_recreates": [set_("u1", {"a": 1, "b": 2}, 0),
                                   delete("u1", 5),
                                   set_("u1", {"a": 9}, 10)],
    "never_set_entity_absent": [plain("u1", 0), unset("u2", ["x"], 1)],
    "plain_events_ignored": [set_("u1", {"a": 1}, 0), plain("u1", 100)],
    "same_timestamp_set_right_operand_wins": [set_("u1", {"a": 1}, 5),
                                              set_("u1", {"a": 2}, 5)],
    "multiple_entities": [set_("u1", {"a": 1}, 0), set_("u2", {"a": 2}, 0)],
}

EXPECT = {
    "last_write_wins": {"u1": ({"a": 2, "b": 0}, at(0), at(10))},
    "unset_removes_only_older_sets": {"u1": ({"a": 3, "b": 1}, at(0),
                                             at(10))},
    "unset_wins_tie_with_set": {"u1": ({}, at(5), at(5))},
    "unset_tie_leaves_remaining_fields": {"u1": ({"b": 2}, at(5), at(5))},
    "delete_removes_entity": {},
    "delete_tie_wins_over_set": {},
    "set_after_delete_recreates": {"u1": ({"a": 9}, at(0), at(10))},
    "never_set_entity_absent": {},
    "plain_events_ignored": {"u1": ({"a": 1}, at(0), at(0))},
    "same_timestamp_set_right_operand_wins": {"u1": ({"a": 2}, at(5),
                                                     at(5))},
    "multiple_entities": {"u1": ({"a": 1}, at(0), at(0)),
                          "u2": ({"a": 2}, at(0), at(0))},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_aggregation_case_matches_jax(case):
    assert norm(both(CASES[case])) == EXPECT[case]


def _random_spec(rng, n, distinct_times):
    times = (rng.sample(range(1000), n) if distinct_times
             else [rng.randrange(0, 50) for _ in range(n)])
    spec = []
    for t in times:
        kind = rng.choice(["set", "set", "set", "unset", "delete", "plain"])
        keys = rng.sample("abcde", rng.randrange(1, 4))
        if kind == "set":
            spec.append(set_("u", {k: rng.randrange(10) for k in keys}, t))
        elif kind == "unset":
            spec.append(unset("u", keys, t))
        elif kind == "delete":
            spec.append(delete("u", t))
        else:
            spec.append(plain("u", t))
    return spec


def test_combine_order_independent_matches_jax():
    """A monoid combine in shuffled order equals the time-ordered replay
    (distinct times), and both equal the JAX package's single-entity
    aggregation."""
    rng = random.Random(42)
    for trial in range(200):
        spec = _random_spec(rng, rng.randrange(1, 12), True)
        seq = pagg.aggregate_properties_single(
            sorted(build(pev, spec), key=lambda e: e.event_time))
        jseq = jagg.aggregate_properties_single(
            sorted(build(jev, spec), key=lambda e: e.event_time))
        assert norm(seq) == norm(jseq), trial
        shuffled = build(pev, spec)
        rng.shuffle(shuffled)
        acc = pagg.EventOp()
        for e in shuffled:
            acc = acc.combine(pagg.EventOp.from_event(e))
        assert norm(acc.to_property_map()) == norm(seq), trial


def test_associativity_and_ops_match_jax():
    rng = random.Random(7)
    for _ in range(100):
        spec = _random_spec(rng, 3, False)
        a, b, c = (pagg.EventOp.from_event(e) for e in build(pev, spec))
        ja, jb, jc = (jagg.EventOp.from_event(e) for e in build(jev, spec))
        left = a.combine(b).combine(c)
        assert left.combine(pagg.EventOp()) == a.combine(b.combine(c))
        assert a.combine(b) == b.combine(a)
        jleft = ja.combine(jb).combine(jc)
        assert (left.set_fields, left.set_t, left.unset_fields,
                left.delete_t, left.first_updated, left.last_updated) == (
            jleft.set_fields, jleft.set_t, jleft.unset_fields,
            jleft.delete_t, jleft.first_updated, jleft.last_updated)


def test_op_from_parts_matches_from_event():
    for name, props in (("$set", {"a": 1}), ("$unset", {"a": None}),
                        ("$delete", None), ("view", None)):
        e = build(pev, [(name, "u", props, 3)])[0]
        assert pagg.op_from_parts(name, props, pev.to_millis(at(3))) == \
            pagg.EventOp.from_event(e)


# -- the stores ---------------------------------------------------------------

def _store_spec():
    """Items with categories set, unset, deleted and re-set over several
    days (several PEVLOG segments), users' $set, plain views between."""
    rng = random.Random(3)
    spec = []
    for n in range(40):
        t = rng.randrange(0, 6 * 24 * 60)
        kind = rng.random()
        if kind < 0.55:
            spec.append(set_(f"i{n % 12}", {
                "categories": rng.sample(["a", "b", "c", "d"], 2),
                "price": rng.randrange(100)}, t))
        elif kind < 0.7:
            spec.append(unset(f"i{n % 12}", ["price"], t))
        elif kind < 0.8:
            spec.append(delete(f"i{n % 12}", t))
        else:
            spec.append(plain(f"i{n % 12}", t))
    return spec


def _fill(store, mod, spec, ext_id=False):
    store.init(1)
    evs = build(mod, spec, entity_type="item")
    evs += build(mod, [set_("u1", {"age": 3}, 7)], entity_type="user")
    if ext_id:   # an external event id: PEVLOG's raw path cannot replay it
        evs.append(mod.Event(event="$set", entity_type="item",
                             entity_id="i99",
                             properties=mod.DataMap({"price": 1}),
                             event_time=at(9), event_id="external-1"))
    store.insert_batch(evs, 1)
    return store


def _port_stores(tmp_path):
    return {
        "MEM": MemEvents(MemStorageClient()),
        "SQLITE": SQLiteEvents(SQLiteStorageClient(
            {"PATH": str(tmp_path / "pio.db")})),
        "PEVLOG": PevlogEvents(PevlogStorageClient(
            {"PATH": str(tmp_path / "pev"), "BUCKET_HOURS": 24})),
    }


@pytest.mark.parametrize("ext_id", [False, True],
                         ids=["raw_path", "base_fallback"])
@pytest.mark.parametrize("driver", ["MEM", "SQLITE", "PEVLOG"])
def test_store_aggregate_properties_matches_jax(tmp_path, driver, ext_id,
                                                monkeypatch):
    spec = _store_spec()
    jstore = _fill(JMemEvents(JMemClient()), jev, spec, ext_id)
    store = _fill(_port_stores(tmp_path)[driver], pev, spec, ext_id)
    if driver == "PEVLOG":
        base_calls = []
        real = PevlogEvents.__mro__[1].aggregate_properties

        def spy(self, *a, **k):
            base_calls.append(1)
            return real(self, *a, **k)
        monkeypatch.setattr(PevlogEvents.__mro__[1], "aggregate_properties",
                            spy)
    for kw in ({}, {"required": ["price"]},
               {"start_time": at(24 * 60), "until_time": at(4 * 24 * 60)}):
        want = norm(jstore.aggregate_properties(1, entity_type="item", **kw))
        got = norm(store.aggregate_properties(1, entity_type="item", **kw))
        assert got == want, kw
        assert want   # the spec leaves entities standing
    assert norm(store.aggregate_properties(1, entity_type="user")) == {
        "u1": ({"age": 3}, at(7), at(7))}
    for eid in ("i0", "i5", "nobody"):
        assert norm(store.aggregate_properties_of_entity(
            1, entity_type="item", entity_id=eid)) == norm(
            jstore.aggregate_properties_of_entity(
                1, entity_type="item", entity_id=eid))
    if driver == "PEVLOG":
        # the raw path answers alone unless a frame needs the base path
        assert bool(base_calls) == ext_id


def test_pevlog_cached_replay_path_matches_raw(tmp_path):
    """After a `find` has cached the segments' replay, the aggregation
    reads the cached Events instead of the journal, to the same map."""
    store = _fill(_port_stores(tmp_path)["PEVLOG"], pev, _store_spec())
    raw = norm(store.aggregate_properties(1, entity_type="item"))
    list(store.find(1))
    assert store.c.replay_cache
    assert norm(store.aggregate_properties(1, entity_type="item")) == raw


def test_pevlog_directory_written_by_jax_aggregates_alike(tmp_path):
    spec = _store_spec()
    jstore = _fill(JPevlogEvents(JPevlogClient(
        {"PATH": str(tmp_path), "BUCKET_HOURS": 24})), jev, spec)
    store = PevlogEvents(PevlogStorageClient({"PATH": str(tmp_path),
                                              "BUCKET_HOURS": 24}))
    for kw in ({}, {"required": ["categories"]}):
        assert norm(store.aggregate_properties(
            1, entity_type="item", **kw)) == norm(
            jstore.aggregate_properties(1, entity_type="item", **kw))
