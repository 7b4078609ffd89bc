"""Two storage repairs of the port, on the CPU.

- Several processes opening one NEW sqlite store at once: every open
  succeeds (the WAL switch is skipped once the file reads `wal`, and the
  switch and the schema are retried while another opener holds the
  lock). The JAX package's client keeps raising `database is locked`
  there (ROADMAP.md, "by design").
- PEVLOG's Bloom regrow is sized by the distinct keys of each stream,
  not by the key occurrences it remembers, and hands on deduplicated
  digest lists; the sidecar format is unchanged, so the JAX package
  reads what the port wrote."""

import multiprocessing as mp
import sqlite3
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from predictionio_tpu.data import event as jev
from predictionio_tpu.data.storage import pevlog as jpev
from predictionio_tpu_torch.data import event as pev
from predictionio_tpu_torch.data.storage import pevlog as ppev
from predictionio_tpu_torch.data.storage.sqlite import SQLiteStorageClient

pytestmark = pytest.mark.torch

T0 = datetime(2022, 1, 1, tzinfo=timezone.utc)
OPENERS, ROUNDS = 4, 12


def _open_rounds(root, barrier, results):
    """One spawned opener: each round, wait for the others, open the
    round's new file and write through it."""
    from predictionio_tpu_torch.data.storage.sqlite import (
        SQLiteStorageClient as Client)
    ok = 0
    errors = []
    for r in range(ROUNDS):
        barrier.wait(timeout=60)
        try:
            c = Client({"PATH": f"{root}/round{r}.db"})
            with c.lock, c.conn:
                c.conn.execute("INSERT INTO apps (name) VALUES (?)",
                               (f"app-{mp.current_process().name}",))
            c.close()
            ok += 1
        except sqlite3.OperationalError as e:
            errors.append(str(e))
    results.put((ok, errors))


def test_many_processes_open_one_new_sqlite_store(tmp_path):
    ctx = mp.get_context("spawn")
    barrier = ctx.Barrier(OPENERS)
    results = ctx.Queue()
    procs = [ctx.Process(target=_open_rounds,
                         args=(str(tmp_path), barrier, results))
             for _ in range(OPENERS)]
    for p in procs:
        p.start()
    got = [results.get(timeout=240) for _ in procs]
    for p in procs:
        p.join(timeout=60)
    assert all(p.exitcode == 0 for p in procs)
    assert [errors for _, errors in got] == [[]] * OPENERS
    assert sum(ok for ok, _ in got) == OPENERS * ROUNDS
    for r in range(ROUNDS):
        c = SQLiteStorageClient({"PATH": str(tmp_path / f"round{r}.db")})
        assert c.conn.execute("PRAGMA journal_mode").fetchone()[0] == "wal"
        assert c.conn.execute("SELECT COUNT(*) FROM apps").fetchone()[0] \
            == OPENERS
        c.close()


def test_an_open_store_is_not_switched_again(tmp_path):
    first = SQLiteStorageClient({"PATH": str(tmp_path / "pio.db")})
    seen = []
    second = SQLiteStorageClient.__new__(SQLiteStorageClient)
    second.conn = sqlite3.connect(str(tmp_path / "pio.db"),
                                  check_same_thread=False)
    second.conn.set_trace_callback(seen.append)
    second.lock = first.lock
    second._init_schema()
    assert "PRAGMA journal_mode" in seen
    assert not any("journal_mode=WAL" in s for s in seen)
    first.close()
    second.conn.close()


def test_regrow_sizes_by_distinct_keys_and_drops_repeats():
    """10,000 occurrences of 3,000 property keys: the regrown filter is
    sized for 3,000 keys (the old rule sized it for 10,000), the lists
    it hands on hold each digest once, and every key is found."""
    ix = ppev._SegmentIndex()
    rng = np.random.default_rng(0)
    values = [int(v) for v in rng.permutation(10_000) % 3_000]
    for v in values:
        ix.pfilled += ix._bits_add(ix.pbloom, "n", ppev._value_key(v), 2)
    for u in range(5):
        for _ in range(2_000):
            ix._bloom_add("user", f"u{u}")
    assert len(ix.digests[2]) == 10_000 and len(ix.digests[0]) == 10_000
    grown = ix.regrow_from_digests()
    assert grown.bits == max(ppev._bloom_bits_for(2 * 3_000), 2 * ix.bits)
    assert grown.bits < ppev._bloom_bits_for(2 * 10_000)
    assert [len(d) for d in grown.digests] == [5, 0, 3_000]
    assert all(grown.may_contain_property("n", v) for v in range(3_000))
    assert all(grown.may_contain("user", f"u{u}") for u in range(5))


def _events(mod, rng, n, start):
    return [mod.Event(event="rate", entity_type="user",
                      entity_id=f"u{k % 5}",
                      properties=mod.DataMap({"n": int(v)}),
                      event_time=T0 + timedelta(seconds=start + k))
            for k, v in enumerate(rng.integers(0, 10_000, n))]


def test_regrown_sidecar_is_read_by_both_packages(tmp_path):
    """Few entities, many events, property values repeating: appends
    until the filter regrows; its bits follow the distinct keys; the
    port re-opening the directory and the JAX package's PEVLOG both read
    the sidecar the port wrote and find every key."""
    store = ppev.PevlogEvents(ppev.PevlogStorageClient(
        {"PATH": str(tmp_path), "BUCKET_HOURS": 24}))
    store.init(1)
    rng = np.random.default_rng(1)
    written = []
    seg = None
    for batch in range(60):
        evs = _events(pev, rng, 500, batch * 500)
        store.insert_batch(evs, 1)
        written += evs
        seg = store._segments(store._part_dir(1, None))[0]
        if store._index(seg).bits > ppev._BLOOM_BITS:
            break
    ix = store._index(seg)
    assert ix.bits > ppev._BLOOM_BITS, "no regrow happened"
    values = {int(e.properties.fields["n"]) for e in written}
    assert ix.bits <= max(ppev._bloom_bits_for(2 * len(values)),
                          4 * ppev._BLOOM_BITS)
    assert ix.bits < ppev._bloom_bits_for(2 * len(written))
    store.close()                            # persists the sidecar
    assert seg.with_suffix(".idx").exists()
    by_user = {f"u{u}": sum(1 for e in written if e.entity_id == f"u{u}")
               for u in range(5)}
    for mod, pv in ((pev, ppev), (jev, jpev)):
        reader = pv.PevlogEvents(pv.PevlogStorageClient(
            {"PATH": str(tmp_path), "BUCKET_HOURS": 24}))
        rix = reader._index(seg)
        assert rix.bits == ix.bits, pv.__name__
        assert all(rix.may_contain("user", u) for u in by_user)
        assert all(rix.may_contain_property("n", v) for v in values)
        for u, n in by_user.items():
            assert len(list(reader.find(1, entity_type="user",
                                        entity_id=u))) == n
        reader.close()
