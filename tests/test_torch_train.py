"""The port's training slice end to end on the CPU: rating columns and
their `.npz`, `Engine.train` with the recommendation template
(`ALSAlgorithm.train` over `ops.als.als_train`), engine.json variants
parsed as the JAX engine parses them, and `cli train` -> model `.npz` ->
`cli deploy --device cpu` -> `/queries.json`. A model the port trained
answers `batch_predict` as the JAX template does on the same factors
(the same item lists; scores to rtol 1e-5, the fp32 summation order of
the two matmuls being the only difference)."""

import json
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu.ingest import BiMap as JBiMap
from predictionio_tpu.models import recommendation as jrec
from predictionio_tpu.ops import als as jals
from predictionio_tpu_torch.cli import main as cli
from predictionio_tpu_torch.core.params import EmptyParams, ParamsError
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.ingest.arrays import RatingColumns
from predictionio_tpu_torch.ingest.bimap import BiMap
from predictionio_tpu_torch.models import recommendation as prec
from predictionio_tpu_torch.ops import als as pals

pytestmark = pytest.mark.torch

REPO = Path(__file__).resolve().parents[1]
N_USERS, N_ITEMS = 50, 80
USERS = [f"u{n}" for n in range(N_USERS)]
ITEMS = [f"i{n}" for n in range(N_ITEMS)]


def _columns(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, N_USERS - 2, n).astype(np.int32)  # 2 unrated users
    i = rng.integers(0, N_ITEMS, n).astype(np.int32)
    r = rng.integers(1, 6, n).astype(np.float32)
    return RatingColumns(u, i, r, np.arange(n, dtype=np.int64),
                         BiMap.from_keys(USERS), BiMap.from_keys(ITEMS))


def _variant(rank=24, iters=3, reg=0.05, seed=1):
    return {"id": "default", "engineFactory": "recommendation",
            "datasource": {"params": {"app_name": "MyApp"}},
            "algorithms": [{"name": "als", "params": {
                "rank": rank, "num_iterations": iters, "lambda_": reg,
                "seed": seed}}]}


def test_rating_columns_npz_round_trip(tmp_path):
    cols = _columns()
    cols.save_npz(tmp_path / "r.npz")
    back = RatingColumns.load_npz(tmp_path / "r.npz")
    assert back.n == cols.n == 2000
    for f in ("user_ix", "item_ix", "rating", "t_millis"):
        a, b = getattr(back, f), getattr(cols, f)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert back.users == cols.users and back.items == cols.items


def test_rating_columns_npz_is_checked(tmp_path):
    cols = _columns()
    cols.item_ix[5] = N_ITEMS
    cols.save_npz(tmp_path / "bad.npz")
    with pytest.raises(ValueError, match="item index lies outside"):
        RatingColumns.load_npz(tmp_path / "bad.npz")
    cols = _columns()
    np.savez(tmp_path / "short.npz", user_ix=cols.user_ix,
             item_ix=cols.item_ix[:-1], rating=cols.rating,
             t_millis=cols.t_millis, user_ids=np.array(USERS),
             item_ids=np.array(ITEMS))
    with pytest.raises(ValueError, match="differ in length"):
        RatingColumns.load_npz(tmp_path / "short.npz")
    np.savez(tmp_path / "dup.npz", user_ix=cols.user_ix,
             item_ix=cols.item_ix, rating=cols.rating,
             t_millis=cols.t_millis, user_ids=np.array(USERS[:-1] + ["u0"]),
             item_ids=np.array(ITEMS))
    with pytest.raises(ValueError, match="duplicate ids"):
        RatingColumns.load_npz(tmp_path / "dup.npz")


def test_variant_parses_as_the_jax_engine_does():
    variant = _variant()
    jp = jrec.RecommendationEngine.apply().engine_params_from_variant(
        variant)
    pp = prec.RecommendationEngine.apply().engine_params_from_variant(
        json.dumps(variant))
    (jname, jparams), = jp.algorithm_params_list
    (pname, pparams), = pp.algorithm_params_list
    assert pname == jname == "als"
    assert (pparams.rank, pparams.num_iterations, pparams.lambda_,
            pparams.seed) == (jparams.rank, jparams.num_iterations,
                              jparams.lambda_, jparams.seed)
    assert pp.data_source_params[1].app_name == "MyApp"
    assert pp.preparator_params == ("", EmptyParams())
    for bad in ({"algorithms": [{"name": "nope"}]},
                {"algorithms": [{"name": "als", "params": {"rnk": 3}}]},
                {"version": 1}):
        with pytest.raises(ParamsError):
            prec.RecommendationEngine.apply().engine_params_from_variant(bad)
        with pytest.raises(Exception):
            jrec.RecommendationEngine.apply().engine_params_from_variant(bad)


def test_engine_train_runs_the_template_on_the_cpu():
    engine = prec.RecommendationEngine.apply()
    ctx = RuntimeContext(device="cpu", ratings=_columns())
    model, = engine.train(ctx, engine.engine_params_from_variant(
        _variant()))
    assert isinstance(model, pals.ALSModel)
    assert model.user_factors.shape == (N_USERS, 24)
    assert model.item_factors.shape == (N_ITEMS, 24)
    assert model.device.type == "cpu"
    assert bool((model.user_factors[-2:] == 0).all())
    tm = ctx.phase_timings
    assert {"read_s", "prepare_s", "train_algo0_s", "pack_s", "transfer_s",
            "solve_s", "fetch_s", "solver_residual"} <= set(tm)
    assert tm["solver_residual"] < 1e-2


def test_engine_train_checks():
    engine = prec.RecommendationEngine.apply()
    params = engine.engine_params_from_variant(_variant())
    with pytest.raises(ValueError, match="carries no ratings"):
        engine.train(RuntimeContext(device="cpu"), params)
    empty = _columns(n=0)
    with pytest.raises(ValueError, match="No rating events"):
        engine.train(RuntimeContext(device="cpu", ratings=empty), params)


def test_train_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    engine = prec.RecommendationEngine.apply()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.train(RuntimeContext(ratings=_columns()),
                     engine.engine_params_from_variant(_variant()))


@pytest.mark.parametrize("rank", [8, 24])
def test_trained_model_predicts_as_the_jax_template(rank):
    """Trained by the port (exact path at rank 8, bf16 CG at 24), the
    model's answers equal the JAX template's on the same factors."""
    cols = _columns()
    algo = prec.ALSAlgorithm(prec.ALSAlgorithmParams(
        rank=rank, num_iterations=4, lambda_=0.05, seed=3))
    model = algo.train(RuntimeContext(device="cpu"), cols)
    model.sanity_check()
    x, y = model.user_factors.numpy(), model.item_factors.numpy()
    jmodel = jals.ALSModel(x, y, JBiMap.from_keys(USERS),
                           JBiMap.from_keys(ITEMS))
    jalgo = jrec.ALSAlgorithm(jrec.ALSAlgorithmParams())
    jalgo.warm_serving(jmodel, [1, 2, 4, 8])
    assert algo.warm_serving(model, [1, 2, 4, 8]) == 4
    queries = [dict(user="u1", num=4, blackList=["i0", "i3"]),
               dict(user="u2", num=10), dict(user="u49", num=3),
               dict(user="ghost", num=2),
               dict(user="u5", num=5, whiteList=ITEMS[10:40]),
               dict(user="u7", num=15)]
    jout = dict(jalgo.batch_predict(
        jmodel, [(n, jrec.Query(**q)) for n, q in enumerate(queries)]))
    pout = dict(algo.batch_predict(
        model, [(n, prec.Query(**q)) for n, q in enumerate(queries)]))
    assert jout.keys() == pout.keys()
    for n in jout:
        j = [(s.item, s.score) for s in jout[n].itemScores]
        p = [(s.item, s.score) for s in pout[n].itemScores]
        assert [it for it, _ in p] == [it for it, _ in j]
        np.testing.assert_allclose([s for _, s in p], [s for _, s in j],
                                   rtol=1e-5, atol=1e-6)
    assert pout[2].itemScores[0].score == 0.0   # u49 rated nothing


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def test_cli_train_then_deploy_serves_the_model(tmp_path):
    """`cli train` writes the model `.npz`; `cli deploy` on the CPU
    serves it, and the answer is the JAX template's on its factors."""
    _columns().save_npz(tmp_path / "r.npz")
    (tmp_path / "engine.json").write_text(json.dumps(_variant()))
    out = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", "train",
         "--ratings", str(tmp_path / "r.npz"), "--model-out",
         str(tmp_path / "m.npz"), "--variant",
         str(tmp_path / "engine.json"), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert (report["users"], report["items"], report["rank"],
            report["device"]) == (N_USERS, N_ITEMS, 24, "cpu")
    assert report["timings"]["solver_residual"] < 1e-2
    model = pals.load_npz(tmp_path / "m.npz", device="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", "deploy",
         "--model", str(tmp_path / "m.npz"), "--port", "0", "--device",
         "cpu", "--batch-max", "4"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving "), proc.stderr.read()
        port = int(line.split("http://127.0.0.1:")[1].split()[0])
        q = {"user": "u3", "num": 5, "blackList": ["i1", "i2"]}
        status, body = _post(port, q)
    finally:
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=60)
    assert code == 0 and status == 200
    jmodel = jals.ALSModel(model.user_factors.numpy(),
                           model.item_factors.numpy(),
                           JBiMap.from_keys(USERS), JBiMap.from_keys(ITEMS))
    (_, want), = jrec.ALSAlgorithm(jrec.ALSAlgorithmParams()).batch_predict(
        jmodel, [(0, jrec.Query(**q))])
    assert [s["item"] for s in body["itemScores"]] == [
        s.item for s in want.itemScores]
    np.testing.assert_allclose([s["score"] for s in body["itemScores"]],
                               [s.score for s in want.itemScores],
                               rtol=1e-5, atol=1e-6)


def test_cli_train_function_writes_the_model(tmp_path):
    _columns().save_npz(tmp_path / "r.npz")
    model, timings = cli.train(tmp_path / "r.npz", tmp_path / "m.npz",
                               device="cpu")
    assert model.user_factors.shape == (N_USERS, 10)   # template defaults
    assert timings["solver_residual"] == 0.0            # exact path
    back = pals.load_npz(tmp_path / "m.npz", device="cpu")
    assert torch.equal(back.user_factors, model.user_factors)
    assert back.users == model.users and back.items == model.items
