"""The port's sequential recommender (`predictionio_tpu_torch.ops.seqrec`,
`models.seqrec`) against the JAX package's, on the CPU.

Tolerances: `build_sequences` bit-identical; from the JAX package's own
weights (`params_from_jax` of its `_init_params`), one batch's loss
within rtol 1e-6 and every gradient within atol 1e-5, the parameters
after 3 Adam steps within atol 1e-5, the encoding within atol 1e-5; one
epoch from the JAX init within 5e-3 of the JAX package's item table
(`tests/test_seqrec.py:90-106`'s bar for two associations of the same
math). From a seed the port's init is its own (`torch.Generator`), so
the port is held to the JAX tests' behaviour bars there."""

import pickle
from datetime import datetime, timedelta, timezone
from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from predictionio_tpu.core import persistence as jpers
from predictionio_tpu.data.storage.base import \
    DeltaInvalidated as JDeltaInvalidated
from predictionio_tpu.ingest import BiMap as JBiMap
from predictionio_tpu.models import seqrec as jsr
from predictionio_tpu.ops import seqrec as jop
from predictionio_tpu_torch.core import persistence as pers
from predictionio_tpu_torch.core.params import EngineParams
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.core.workflow import CoreWorkflow, resolve_engine
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import App, StorageRegistry
from predictionio_tpu_torch.data.storage.base import DeltaInvalidated
from predictionio_tpu_torch.ingest.bimap import BiMap
from predictionio_tpu_torch.models import seqrec as sr
from predictionio_tpu_torch.ops import seqrec as pop
from predictionio_tpu_torch.ops.adam import Adam

pytestmark = pytest.mark.torch

MEM = {"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM",
       "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"}
N_ITEMS, S, D, H, L = 30, 8, 16, 2, 2
TEMP, LR = 0.07, 3e-3


def _markov_events(n_users=800, n_items=100, seed=0):
    """`tests/test_seqrec.py`'s planted chain: each user walks item ->
    item + 1 (mod n) with 10% noise."""
    rng = np.random.RandomState(seed)
    us, its, ts = [], [], []
    for u in range(n_users):
        length = rng.randint(5, 16)
        start = rng.randint(0, n_items)
        for j in range(length):
            noise = rng.randint(5) if rng.rand() < 0.1 else 0
            us.append(u)
            its.append((start + j + noise) % n_items)
            ts.append(j)
    return np.asarray(us), np.asarray(its), np.asarray(ts), n_items


def _jax_init(seed=0, n_items=N_ITEMS, seq_len=S, dim=D, n_layers=L):
    p = jop._init_params(jax.random.PRNGKey(seed), n_items, seq_len, dim,
                         n_layers)
    return jax.tree_util.tree_map(np.asarray, p)


def _batch(n=32, seed=0):
    rng = np.random.RandomState(seed)
    seqs = rng.randint(0, N_ITEMS, (n, S)).astype(np.int32)
    for r in range(n):                     # left padding of every length
        seqs[r, :r % S] = N_ITEMS
    return seqs, rng.randint(0, N_ITEMS, n).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def _jloss():
    return partial(jop._loss_fn, temperature=jnp.float32(TEMP),
                   n_items=N_ITEMS, n_heads=H, n_layers=L, mesh=None)


def _get(tree, dotted):
    for part in dotted.split("."):
        tree = tree[part]
    return np.asarray(tree)


# -- build_sequences -----------------------------------------------------------

@pytest.mark.parametrize("u,i,t,seq_len,want_seqs,want_targets", [
    ([7, 7, 7, 9], [3, 4, 5, 1], [0, 1, 2, 0], 4, [[10, 10, 3, 4]], [5]),
    ([0] * 10, list(range(10)), list(range(10)), 4, [[5, 6, 7, 8]], [9]),
    ([1, 1, 1], [5, 3, 4], [2, 0, 1], 4, [[10, 10, 3, 4]], [5]),
])
def test_build_sequences_cases(u, i, t, seq_len, want_seqs, want_targets):
    """`tests/test_seqrec.py::TestBuildSequences`' three cases (a single
    event dropped, truncation to the recent, time order), in both."""
    args = (np.array(u), np.array(i), np.array(t))
    n_items = 20 if len(u) == 10 else 10
    got = pop.build_sequences(*args, n_items=n_items, seq_len=seq_len)
    want = jop.build_sequences(*args, n_items=n_items, seq_len=seq_len)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert np.array_equal(got[0], [[x if x != 10 else n_items for x in r]
                                   for r in want_seqs])
    assert np.array_equal(got[1], want_targets)


@pytest.mark.parametrize("min_len", [1, 2, 5])
def test_build_sequences_bit_identical_on_random_events(min_len):
    rng = np.random.RandomState(min_len)
    n = 3_000
    u = rng.randint(0, 200, n).astype(np.int64)
    i = rng.randint(0, 50, n).astype(np.int64)
    t = rng.randint(0, 500, n).astype(np.int64)
    got = pop.build_sequences(u, i, t, n_items=50, seq_len=12,
                              min_len=min_len)
    want = jop.build_sequences(u, i, t, n_items=50, seq_len=12,
                               min_len=min_len)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


# -- the transformer against the JAX one ---------------------------------------

def test_loss_and_every_gradient_match_jax():
    init = _jax_init()
    seqs, tgt = _batch()
    want_loss, want = jax.value_and_grad(_jloss())(
        jax.tree_util.tree_map(jnp.asarray, init), jnp.asarray(seqs),
        jnp.asarray(tgt))
    net = pop.SeqRecNet(pop.params_from_jax(init), n_items=N_ITEMS,
                        n_heads=H, device="cpu")
    names = [n for n, _ in net.named_parameters()]
    assert len(names) == 4 + 10 * L and "l1.w2" in names
    loss = net.loss(_t(seqs), _t(tgt), TEMP)
    grads = torch.autograd.grad(loss, list(net.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-6)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), _get(want, name), atol=1e-5,
                                   err_msg=name)
    # the PAD row never reaches a real position: its gradient is 0
    assert not grads[0][N_ITEMS].any()


def test_three_adam_steps_and_the_encoding_match_jax():
    init = _jax_init(1)
    batches = [_batch(seed=s) for s in range(3)]
    tx = optax.adam(LR)
    jp = jax.tree_util.tree_map(jnp.asarray, init)
    state = tx.init(jp)
    for seqs, tgt in batches:
        g = jax.grad(_jloss())(jp, jnp.asarray(seqs), jnp.asarray(tgt))
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
    net = pop.SeqRecNet(pop.params_from_jax(init), n_items=N_ITEMS,
                        n_heads=H, device="cpu")
    adam = Adam(list(net.parameters()), LR)
    for seqs, tgt in batches:
        pop.train_step(net, adam, _t(seqs), _t(tgt), TEMP)
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _get(jp, name),
                                   atol=1e-5, err_msg=name)
    jmodel = jop.SeqRecModel(jax.tree_util.tree_map(np.asarray, jp), S,
                             N_ITEMS, H)
    pmodel = pop.SeqRecModel(net.numpy_params(), S, N_ITEMS, H)
    seqs, _ = _batch(seed=9)
    np.testing.assert_allclose(pop.seqrec_encode(pmodel, seqs, "cpu"),
                               jop.seqrec_encode(jmodel, seqs), atol=1e-5)


def test_one_epoch_from_the_jax_init_within_5e3():
    u, i, t, n_items = _markov_events(n_users=300, seed=2)
    seqs, targets = jop.build_sequences(u, i, t, n_items=n_items,
                                        seq_len=8)
    init = _jax_init(0, n_items=n_items, seq_len=8, dim=32, n_layers=1)
    kw = dict(n_items=n_items, seq_len=8, dim=32, n_heads=2, n_layers=1,
              batch_size=64, epochs=1, seed=0)
    want = jop.seqrec_train(seqs, targets, init_params=init, **kw)
    got = pop.seqrec_train(seqs, targets, init_params=init, device="cpu",
                           **kw)
    assert np.abs(got.item_emb - want.item_emb).max() < 5e-3
    assert np.abs(got.item_emb - init["item_table"][:n_items]).max() > 1e-3


def test_learns_planted_markov_chain():
    """`tests/test_seqrec.py::test_learns_planted_markov_chain`'s bar:
    next-item accuracy above 0.3 (popularity gets about 1 / n_items)."""
    u, i, t, n_items = _markov_events()
    seqs, targets = pop.build_sequences(u, i, t, n_items=n_items, seq_len=8)
    m = pop.seqrec_train(seqs, targets, n_items=n_items, seq_len=8, dim=48,
                         n_heads=2, n_layers=1, batch_size=256, epochs=15,
                         seed=0, device="cpu")
    vecs = pop.seqrec_encode(m, seqs[:400], device="cpu")
    acc = float((np.argmax(vecs @ m.item_emb.T, 1) == targets[:400]).mean())
    assert acc > 0.3, acc


def test_step_hooks_see_every_step_in_order():
    seqs, tgt = _batch(40)
    losses, seen = [], []
    pop.seqrec_train(seqs, tgt, n_items=N_ITEMS, seq_len=S, batch_size=16,
                     epochs=2, device="cpu", step_losses=losses,
                     on_step=seen.append)
    assert seen == list(range(2 * (40 // 16)))
    assert len(losses) == len(seen)
    assert all(torch.isfinite(x) and x.dim() == 0 for x in losses)


def test_raises_without_a_full_batch_or_on_a_width_mismatch():
    seqs, tgt = _batch(8)
    with pytest.raises(ValueError, match="full batch"):
        pop.seqrec_train(seqs, tgt, n_items=N_ITEMS, seq_len=S,
                         batch_size=16, device="cpu")
    with pytest.raises(ValueError, match="wide"):
        pop.seqrec_train(seqs, tgt, n_items=N_ITEMS, seq_len=S + 1,
                         batch_size=4, device="cpu")
    bad = _jax_init()
    bad["l0"] = {k: v for k, v in bad["l0"].items() if k != "wo"}
    with pytest.raises(ValueError, match="l0 keys"):
        pop.params_from_jax(bad)


def test_model_pickles_without_device_cache():
    """`tests/test_seqrec.py::TestPersistence`: the encoder's device copy
    never travels with the pickled model."""
    seqs, tgt = _batch(16)
    m = pop.seqrec_train(seqs, tgt, n_items=N_ITEMS, seq_len=S, dim=16,
                         n_heads=2, n_layers=1, batch_size=16, epochs=1,
                         device="cpu")
    v1 = pop.seqrec_encode(m, seqs[:4], device="cpu")
    assert getattr(m, "_devp", None) is not None
    m2 = pickle.loads(pickle.dumps(m))
    assert getattr(m2, "_devp", None) is None
    np.testing.assert_allclose(pop.seqrec_encode(m2, seqs[:4], "cpu"), v1,
                               atol=1e-6)
    m.sanity_check()


def test_warm_start_resumes_from_params():
    """`tests/test_streaming.py::TestWarmStart`'s seqrec case."""
    rng = np.random.default_rng(3)
    users = np.repeat(np.arange(8), 10).astype(np.int64)
    items = rng.integers(0, 6, size=80).astype(np.int64)
    t = np.arange(80, dtype=np.int64) * 1000
    seqs, targets = pop.build_sequences(users, items, t, n_items=6,
                                        seq_len=8)
    kw = dict(n_items=6, seq_len=8, dim=8, n_heads=2, n_layers=1,
              batch_size=4, epochs=1, seed=0, device="cpu")
    m0 = pop.seqrec_train(seqs, targets, **kw)
    m1 = pop.seqrec_train(seqs, targets, init_params=m0.params, **kw)
    shapes = lambda p: [a.shape for a in pop._leaves(p)]  # noqa: E731
    assert shapes(m0.params) == shapes(m1.params)
    assert 0 < np.abs(m1.item_emb - m0.item_emb).max() < 1.0


def test_encode_requires_cuda_unless_asked_for_the_cpu(monkeypatch):
    seqs, tgt = _batch(16)
    m = pop.seqrec_train(seqs, tgt, n_items=N_ITEMS, seq_len=S, dim=16,
                         batch_size=16, epochs=1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pop.seqrec_encode(m, seqs)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pop.seqrec_train(seqs, tgt, n_items=N_ITEMS, seq_len=S,
                         batch_size=16)


# -- the template ---------------------------------------------------------------

T0 = datetime(2024, 1, 1, tzinfo=timezone.utc)


def _chain_store():
    """`tests/test_seqrec.py::TestEngineTemplate`'s store: 120 users, each
    6 views along the chain of 40 items."""
    reg = StorageRegistry(MEM)
    app_id = reg.get_meta_data_apps().insert(App(0, "seqapp"))
    events = reg.get_events()
    events.init(app_id)
    rng = np.random.RandomState(0)
    batch = []
    for u in range(120):
        start = rng.randint(0, 40)
        for j in range(6):
            batch.append(Event(
                event="view", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item",
                target_entity_id=f"i{(start + j) % 40}",
                properties=DataMap({}), event_time=T0 + timedelta(minutes=j)))
    for s in range(0, len(batch), 50):
        events.insert_batch(batch[s:s + 50], app_id)
    return reg, app_id


def test_end_to_end_with_serve_time_history():
    """`tests/test_seqrec.py::test_end_to_end_with_serve_time_history`'s
    assertions on a MEM registry, on the CPU."""
    reg, app_id = _chain_store()
    events = reg.get_events()
    engine = resolve_engine("seqrec")
    params = EngineParams(
        data_source_params=("", sr.DataSourceParams(app_name="seqapp")),
        algorithm_params_list=(("seqrec", sr.SeqRecParams(
            app_name="seqapp", seq_len=8, dim=32, n_heads=2, n_layers=1,
            batch_size=64, epochs=25, seed=1)),))
    ctx = RuntimeContext(registry=reg, device="cpu")
    row = CoreWorkflow.run_train(engine, params, ctx)
    algos, models, _ = CoreWorkflow.prepare_deploy(engine, row, ctx)
    algo, model = algos[0], models[0]
    assert model.device == "cpu"
    assert len(algo.predict(model, sr.Query(user="u3", num=5)).itemScores) \
        == 5
    assert algo.predict(model, sr.Query(user="nobody", num=5)).itemScores \
        == ()
    hits = 0
    for u in range(40):
        got = {s.item for s in algo.predict(
            model, sr.Query(user=f"u{u}", num=5)).itemScores}
        evs = sorted(events.find(app_id, entity_type="user",
                                 entity_id=f"u{u}"),
                     key=lambda e: e.event_time)
        hits += f"i{(int(evs[-1].target_entity_id[1:]) + 1) % 40}" in got
    assert hits >= 14, hits
    assert algo.serve_paths["store_reads"] == 42
    # a burst of events on unknown items keeps the known history
    burst = [Event(event="view", entity_type="user", entity_id="u3",
                   target_entity_type="item", target_entity_id=f"newitem{j}",
                   properties=DataMap({}),
                   event_time=T0 + timedelta(hours=1, minutes=j))
             for j in range(8)]
    events.insert_batch(burst, app_id)
    assert len(algo.predict(model, sr.Query(user="u3", num=5)).itemScores) \
        == 5, "history emptied by unknown-item burst"
    # the port's blob holds the port's classes; a JAX blob is refused
    back = pers.loads(pers.dumps(models))
    assert type(back[0]) is sr.SeqRecServingModel
    assert getattr(back[0].net, "_devp", None) is None
    jm = jsr.SeqRecServingModel(
        jop.SeqRecModel(_jax_init(), S, N_ITEMS, H),
        JBiMap.from_keys(["a"]), JBiMap.from_keys(["x"]))
    blob = jpers.serialize_models("iid", [object()], [jm], None)
    with pytest.raises(pers.ForeignModelError, match="JAX package"):
        pers.deserialize_models(blob, "iid", [object()], None, None)


# -- fold-in ----------------------------------------------------------------------

def _cols(rows):
    """Scan columns of (user, item, t) rows in first-seen order, for both
    packages' fold contexts."""
    ents, tgts = {}, {}
    e_ix = [ents.setdefault(u, len(ents)) for u, _, _ in rows]
    t_ix = [tgts.setdefault(i, len(tgts)) for _, i, _ in rows]
    return SimpleNamespace(
        entity_ix=np.array(e_ix, np.int32), target_ix=np.array(t_ix, np.int32),
        t_millis=np.array([t for _, _, t in rows], np.int64),
        entities=list(ents), targets=list(tgts), n=len(rows))


def _fctx(full, delta):
    ns = SimpleNamespace(ds_params={}, mesh=None, app_id=1, channel_id=None,
                         delta_columns=lambda **kw: delta,
                         history_columns=lambda **kw: full)
    ns.store = SimpleNamespace(scan_columns=lambda *a, **kw: full)
    return ns


def _trained():
    """A model trained by the JAX package from its init, served by both."""
    u, i, t, n_items = _markov_events(n_users=200, n_items=N_ITEMS, seed=4)
    rows = [(f"u{a}", f"i{b}", int(c)) for a, b, c in zip(u, i, t)]
    items = [f"i{n}" for n in range(N_ITEMS)]
    seqs, targets = jop.build_sequences(u, i, t, n_items=N_ITEMS, seq_len=S)
    net = jop.seqrec_train(seqs, targets, n_items=N_ITEMS, seq_len=S, dim=D,
                           n_heads=H, n_layers=L, batch_size=64, epochs=1,
                           init_params=_jax_init(5))
    users = sorted({r[0] for r in rows})
    jmodel = jsr.SeqRecServingModel(net, JBiMap.from_keys(users),
                                    JBiMap.from_keys(items))
    pmodel = sr.SeqRecServingModel(
        pop.SeqRecModel(pop.params_from_jax(net.params), S, N_ITEMS, H),
        BiMap.from_keys(users), BiMap.from_keys(items), "cpu")
    return rows, jmodel, pmodel


PARAMS = dict(seq_len=S, dim=D, n_heads=H, n_layers=L, batch_size=64)


def test_fold_in_matches_the_jax_fold_and_takes_new_users():
    rows, jmodel, pmodel = _trained()
    rows = rows + [("newcomer", "i1", 0), ("newcomer", "i2", 1)]
    full, delta = _cols(rows), _cols(rows[-2:])
    want = jsr.SeqRecAlgorithm(jsr.SeqRecParams(**PARAMS)).fold_in(
        jmodel, None, _fctx(full, delta))
    got = sr.SeqRecAlgorithm(sr.SeqRecParams(**PARAMS)).fold_in(
        pmodel, None, _fctx(full, delta))
    assert got.device == "cpu" and got.users is pmodel.users
    assert np.abs(got.net.item_emb - want.net.item_emb).max() < 5e-3
    assert np.abs(got.net.item_emb - pmodel.net.item_emb).max() > 0


def test_fold_in_invalidates_on_a_new_item_only():
    rows, jmodel, pmodel = _trained()
    rows = rows + [("u1", "brand-new", 99)]
    full, delta = _cols(rows), _cols(rows[-1:])
    with pytest.raises(JDeltaInvalidated):
        jsr.SeqRecAlgorithm(jsr.SeqRecParams(**PARAMS)).fold_in(
            jmodel, None, _fctx(full, delta))
    with pytest.raises(DeltaInvalidated):
        sr.SeqRecAlgorithm(sr.SeqRecParams(**PARAMS)).fold_in(
            pmodel, None, _fctx(full, delta))
    assert sr.SeqRecAlgorithm(sr.SeqRecParams(**PARAMS)).fold_in(
        pmodel, None, _fctx(full, _cols([]))) is None
