"""The port's two-tower recommender (`predictionio_tpu_torch.ops.twotower`,
`models.twotower`, `models.common.score_and_rank`) against the JAX
package's, on the CPU.

Tolerances: from the JAX package's own weights (`params_from_jax` of its
`_init_params`), one batch's loss within rtol 1e-6 and every gradient
within atol 1e-6, the parameters after 3 Adam steps and the towers
they materialize within atol 1e-5 (Adam divides each gradient by its
own root mean square, so an ulp of a small gradient moves a weight by
more than an ulp); one epoch from the JAX init within 5e-3 of the JAX
package's embeddings (`tests/test_seqrec.py`'s bar for two associations
of the same math). The port's own init draws
from a `torch.Generator`, so from a seed the port is held to the JAX
tests' behaviour bars, not to the JAX weights."""

import pickle
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
from predictionio_tpu.models import common as jcommon
from predictionio_tpu.models import twotower as jtt
from predictionio_tpu.models.recommendation import Query as JQuery
from predictionio_tpu.ops import twotower as jop
from predictionio_tpu_torch.core import persistence as pers
from predictionio_tpu_torch.core.params import EngineParams
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.core.workflow import CoreWorkflow, resolve_engine
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import App, StorageRegistry
from predictionio_tpu_torch.data.storage.base import DeltaInvalidated
from predictionio_tpu_torch.ingest.bimap import BiMap
from predictionio_tpu_torch.models import common
from predictionio_tpu_torch.models import twotower as tt
from predictionio_tpu_torch.models.recommendation import Query
from predictionio_tpu_torch.ops import twotower as pop
from predictionio_tpu_torch.ops.adam import Adam

pytestmark = pytest.mark.torch

MEM = {"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM",
       "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"}
N_USERS, N_ITEMS, EMB, HID, OUT = 40, 30, 8, 16, 8
TEMP, LR = 0.1, 1e-2


def _jax_init(seed=0):
    p = jop._init_params(jax.random.PRNGKey(seed), N_USERS, N_ITEMS, EMB,
                         HID, OUT)
    return {k: np.asarray(v) for k, v in p.items()}


def _pairs(n=256, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, N_USERS, n).astype(np.int32),
            rng.randint(0, N_ITEMS, n).astype(np.int32))


def test_loss_and_every_gradient_match_jax():
    init = _jax_init()
    u, i = _pairs(64)
    want_loss, want = jax.value_and_grad(jop._loss_fn)(
        {k: jnp.asarray(v) for k, v in init.items()}, jnp.asarray(u),
        jnp.asarray(i), TEMP)
    net = pop.TwoTowerNet(pop.params_from_jax(init), device="cpu")
    loss = net.loss(torch.from_numpy(u.astype(np.int64)),
                    torch.from_numpy(i.astype(np.int64)), TEMP)
    grads = torch.autograd.grad(loss, list(net.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-6)
    for name, g in zip(pop.PARAM_NAMES, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]),
                                   atol=1e-6, err_msg=name)
    # dense embedding gradients: untouched rows are exactly 0 in both
    untouched = np.setdiff1d(np.arange(N_USERS), u)
    assert untouched.size and not grads[0][untouched].any()


def test_three_adam_steps_and_towers_match_jax():
    init = _jax_init(1)
    batches = [_pairs(64, seed=s) for s in range(3)]
    tx = optax.adam(LR)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    for u, i in batches:
        g = jax.grad(jop._loss_fn)(jp, jnp.asarray(u), jnp.asarray(i), TEMP)
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
    net = pop.TwoTowerNet(pop.params_from_jax(init), device="cpu")
    adam = Adam(list(net.parameters()), LR)
    for u, i in batches:
        pop.train_step(net, adam, torch.from_numpy(u.astype(np.int64)),
                       torch.from_numpy(i.astype(np.int64)), TEMP)
    got = net.numpy_params()
    for name in pop.PARAM_NAMES:
        np.testing.assert_allclose(got[name], np.asarray(jp[name]),
                                   atol=1e-5, err_msg=name)
    with torch.no_grad():
        towers = net.tower("item", torch.arange(N_ITEMS)).numpy()
    want = jop._tower(jp["item_table"], jp["item_w1"], jp["item_w2"],
                      jnp.arange(N_ITEMS))
    np.testing.assert_allclose(towers, np.asarray(want), atol=1e-5)


def test_one_epoch_from_the_jax_init_within_5e3():
    """Same init, same `RandomState` batches: after one epoch the port's
    towers are within 5e-3 of the JAX package's."""
    init = _jax_init(2)
    u, i = _pairs(600, seed=3)
    kw = dict(n_users=N_USERS, n_items=N_ITEMS, emb_dim=EMB, hidden=HID,
              out_dim=OUT, batch_size=128, epochs=1, seed=4)
    want = jop.twotower_train(u, i, init_params=init, **kw)
    got = pop.twotower_train(u, i, init_params=init, device="cpu", **kw)
    for a, b in ((got.item_emb, want.item_emb),
                 (got.user_emb, want.user_emb)):
        assert np.abs(a - b).max() < 5e-3
    for k in pop.PARAM_NAMES:
        assert np.abs(got.params[k] - want.params[k]).max() < 5e-3, k


def test_step_losses_hold_one_loss_per_step():
    u, i = _pairs(300, seed=5)
    losses = []
    pop.twotower_train(u, i, n_users=N_USERS, n_items=N_ITEMS, emb_dim=EMB,
                       hidden=HID, out_dim=OUT, batch_size=64, epochs=2,
                       device="cpu", step_losses=losses)
    assert len(losses) == 2 * (300 // 64)
    assert all(torch.isfinite(x) and x.dim() == 0 for x in losses)


def test_on_step_sees_every_step_in_order():
    u, i = _pairs(300, seed=5)
    seen = []
    pop.twotower_train(u, i, n_users=N_USERS, n_items=N_ITEMS, emb_dim=EMB,
                       hidden=HID, out_dim=OUT, batch_size=64, epochs=3,
                       device="cpu", on_step=seen.append)
    assert seen == list(range(3 * (300 // 64)))


def test_learns_block_structure():
    """`tests/test_twotower.py::test_learns_block_structure`'s bar."""
    rng = np.random.RandomState(0)
    rows, cols = [], []
    for u in range(30):
        for i in range(24):
            if i % 3 == u % 3 and rng.rand() < 0.9:
                rows.append(u)
                cols.append(i)
    model = pop.twotower_train(
        np.array(rows, np.int32), np.array(cols, np.int32),
        n_users=30, n_items=24, emb_dim=16, hidden=32, out_dim=16,
        batch_size=64, epochs=30, seed=0, device="cpu")
    scores = model.user_emb @ model.item_emb.T
    correct = 0
    for u in range(30):
        block = {i for i in range(24) if i % 3 == u % 3}
        correct += len(set(np.argsort(-scores[u])[:8].tolist()) & block)
    assert correct / (30 * 8) > 0.8


def test_empty_raises_and_params_are_checked():
    with pytest.raises(ValueError, match="no interaction pairs"):
        pop.twotower_train(np.zeros(0, np.int32), np.zeros(0, np.int32),
                           n_users=1, n_items=1, device="cpu")
    init = _jax_init()
    with pytest.raises(ValueError, match="missing"):
        pop.params_from_jax({k: v for k, v in init.items()
                             if k != "item_w2"})
    bad = dict(init, user_w2=np.zeros((HID + 1, OUT), np.float32))
    with pytest.raises(ValueError, match="do not chain"):
        pop.params_from_jax(bad)
    copy = pop.params_from_jax(init)
    assert all(copy[k] is not init[k] and np.array_equal(copy[k], init[k])
               for k in pop.PARAM_NAMES)


def test_warm_start_resumes_from_params():
    """`tests/test_streaming.py::TestWarmStart`'s two-tower case."""
    rng = np.random.default_rng(2)
    u = rng.integers(0, 6, size=64).astype(np.int64)
    i = rng.integers(0, 5, size=64).astype(np.int64)
    kw = dict(n_users=6, n_items=5, emb_dim=8, hidden=8, out_dim=8,
              batch_size=32, epochs=1, seed=0, device="cpu")
    m0 = pop.twotower_train(u, i, **kw)
    m1 = pop.twotower_train(u, i, init_params=m0.params, **kw)
    drift = max(float(np.max(np.abs(m1.params[k] - m0.params[k])))
                for k in m0.params)
    assert all(m1.params[k].shape == m0.params[k].shape for k in m0.params)
    assert 0.0 < drift < 1.0


def test_score_and_rank_matches_the_jax_one():
    rng = np.random.RandomState(6)
    items = [f"i{n}" for n in range(N_ITEMS)]
    vecs = rng.randn(5, OUT).astype(np.float32)
    emb = rng.randn(N_ITEMS, OUT).astype(np.float32)
    qs = [dict(user="a", num=4), dict(user="b", num=50, blackList=["i3"]),
          dict(user="c", num=3, whiteList=["i1", "i2", "nope"]),
          dict(user="d", num=2, whiteList=[]),
          dict(user="e", num=6, blackList=["i0", "i1"])]
    got = common.score_and_rank(vecs, emb, BiMap.from_keys(items),
                                [(n, Query(**q)) for n, q in enumerate(qs)],
                                device="cpu")
    want = jcommon.score_and_rank(
        vecs, emb, JBiMap.from_keys(items),
        [(n, JQuery(**q)) for n, q in enumerate(qs)])
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert [s.item for s in g.itemScores] == \
            [s.item for s in w.itemScores]
        np.testing.assert_allclose([s.score for s in g.itemScores],
                                   [s.score for s in w.itemScores],
                                   atol=1e-6)
    assert len(got[1][1].itemScores) == N_ITEMS - 1
    assert got[3][1].itemScores == ()


# -- the template ------------------------------------------------------------

def _block_store():
    reg = StorageRegistry(MEM)
    app_id = reg.get_meta_data_apps().insert(App(0, "ttapp"))
    events = reg.get_events()
    events.init(app_id)
    rng = np.random.RandomState(0)
    for u in range(20):
        for i in range(15):
            if i % 3 == u % 3 and rng.rand() < 0.9:
                events.insert(Event(
                    event="view", entity_type="user", entity_id=f"u{u}",
                    target_entity_type="item",
                    target_entity_id=f"i{i}"), app_id)
    return reg


def _params(**algo):
    return EngineParams(
        data_source_params=("", tt.DataSourceParams(app_name="ttapp")),
        algorithm_params_list=(("twotower", tt.TwoTowerParams(
            emb_dim=16, hidden=32, out_dim=16, batch_size=64, epochs=20,
            seed=0, **algo)),))


def test_template_lifecycle():
    """`tests/test_twotower.py::TestTwoTowerTemplate`'s assertions, through
    `run_train` and `prepare_deploy` on a MEM registry, on the CPU."""
    reg = _block_store()
    ctx = RuntimeContext(registry=reg, device="cpu")
    engine = resolve_engine("twotower")
    row = CoreWorkflow.run_train(engine, _params(), ctx)
    algos, models, serving = CoreWorkflow.prepare_deploy(engine, row, ctx)
    assert models[0].device == "cpu"
    q = Query(user="u1", num=4)
    res = serving.serve(q, [algos[0].predict(models[0], q)])
    assert len(res.itemScores) == 4
    assert np.mean([int(s.item[1:]) % 3 == 1
                    for s in res.itemScores]) >= 0.5, res.itemScores
    assert algos[0].predict(models[0],
                            Query(user="ghost", num=3)).itemScores == ()
    # the port's blob holds the port's classes; a JAX blob is refused
    back = pers.loads(pers.dumps(models))
    assert type(back[0]) is tt.TwoTowerServingModel
    np.testing.assert_array_equal(back[0].net.item_emb,
                                  models[0].net.item_emb)
    jm = jtt.TwoTowerServingModel(
        jop.TwoTowerModel(np.ones((2, 3), np.float32),
                          np.ones((4, 3), np.float32)),
        JBiMap.from_keys(["a", "b"]), JBiMap.from_keys(["w", "x", "y", "z"]))
    blob = jpers.serialize_models("iid", [object()], [jm], None)
    with pytest.raises(pers.ForeignModelError, match="JAX package"):
        pers.deserialize_models(blob, "iid", [object()], None, None)


def test_template_requires_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reg = _block_store()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CoreWorkflow.run_train(resolve_engine("twotower"), _params(),
                               RuntimeContext(registry=reg))
    u, i = _pairs(32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pop.twotower_train(u, i, n_users=N_USERS, n_items=N_ITEMS)


# -- fold-in -----------------------------------------------------------------

def _cols(pairs):
    """Scan columns of (user, item) id pairs in first-seen order, for both
    packages' fold contexts."""
    ents, tgts = {}, {}
    e_ix = [ents.setdefault(u, len(ents)) for u, _ in pairs]
    t_ix = [tgts.setdefault(i, len(tgts)) for _, i in pairs]
    n = len(pairs)
    return SimpleNamespace(
        entity_ix=np.array(e_ix, np.int32), target_ix=np.array(t_ix, np.int32),
        value=np.ones(n, np.float32), t_millis=np.arange(n, dtype=np.int64),
        entities=list(ents), targets=list(tgts), n=n)


def _fctx(full, delta):
    """A fold context over fixed columns: the port's `history_columns`
    and the JAX package's `store.scan_columns` both read `full`."""
    ns = SimpleNamespace(ds_params={}, mesh=None, app_id=1, channel_id=None,
                         delta_columns=lambda **kw: delta,
                         history_columns=lambda **kw: full)
    ns.store = SimpleNamespace(scan_columns=lambda *a, **kw: full)
    return ns


def _trained():
    """One model from the JAX init served by both packages."""
    rng = np.random.RandomState(7)
    users = [f"u{n}" for n in range(N_USERS)]
    items = [f"i{n}" for n in range(N_ITEMS)]
    pairs = [(users[rng.randint(N_USERS)], items[rng.randint(N_ITEMS)])
             for _ in range(400)]
    init = _jax_init(3)
    net = jop.twotower_train(
        np.array([int(u[1:]) for u, _ in pairs]),
        np.array([int(i[1:]) for _, i in pairs]), n_users=N_USERS,
        n_items=N_ITEMS, emb_dim=EMB, hidden=HID, out_dim=OUT,
        batch_size=128, epochs=1, init_params=init)
    jmodel = jtt.TwoTowerServingModel(net, JBiMap.from_keys(users),
                                      JBiMap.from_keys(items))
    pmodel = tt.TwoTowerServingModel(
        pop.TwoTowerModel(net.user_emb, net.item_emb,
                          pop.params_from_jax(net.params)),
        BiMap.from_keys(users), BiMap.from_keys(items), "cpu")
    return pairs, jmodel, pmodel


def test_fold_in_matches_the_jax_fold():
    pairs, jmodel, pmodel = _trained()
    full, delta = _cols(pairs), _cols(pairs[-5:])
    params = dict(emb_dim=EMB, hidden=HID, out_dim=OUT, batch_size=128,
                  seed=3)
    want = jtt.TwoTowerAlgorithm(jtt.TwoTowerParams(**params)).fold_in(
        jmodel, None, _fctx(full, delta))
    got = tt.TwoTowerAlgorithm(tt.TwoTowerParams(**params)).fold_in(
        pmodel, None, _fctx(full, delta))
    assert got.device == "cpu" and got.users is pmodel.users
    assert np.abs(got.net.user_emb - want.net.user_emb).max() < 5e-3
    assert np.abs(got.net.item_emb - want.net.item_emb).max() < 5e-3
    assert np.abs(got.net.item_emb - pmodel.net.item_emb).max() > 0


@pytest.mark.parametrize("case", ["new_user", "new_item", "no_params"])
def test_fold_in_invalidates_like_the_jax_fold(case):
    pairs, jmodel, pmodel = _trained()
    if case == "new_user":
        pairs = pairs + [("stranger", "i1")]
    elif case == "new_item":
        pairs = pairs + [("u1", "brand-new")]
    else:
        pmodel.net.params = None
        jmodel.net.params = None
    full, delta = _cols(pairs), _cols(pairs[-1:])
    params = dict(emb_dim=EMB, hidden=HID, out_dim=OUT)
    with pytest.raises(JDeltaInvalidated):
        jtt.TwoTowerAlgorithm(jtt.TwoTowerParams(**params)).fold_in(
            jmodel, None, _fctx(full, delta))
    with pytest.raises(DeltaInvalidated):
        tt.TwoTowerAlgorithm(tt.TwoTowerParams(**params)).fold_in(
            pmodel, None, _fctx(full, delta))
    # an empty delta folds nothing, in both
    empty = _cols([])
    assert tt.TwoTowerAlgorithm(tt.TwoTowerParams(**params)).fold_in(
        pmodel, None, _fctx(full, empty)) is None


def test_model_pickles_with_numpy_weights_only():
    _, _, pmodel = _trained()
    back = pickle.loads(pickle.dumps(pmodel))
    assert isinstance(back.net.params["user_table"], np.ndarray)
    assert back.device == "cpu"
