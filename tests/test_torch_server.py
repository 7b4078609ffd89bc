"""The port's prediction server (`predictionio_tpu_torch/serving/
server.py`) on the CPU: concurrent `POST /queries.json` requests are
coalesced by the micro-batcher and each answer equals the JAX package's
`batch_predict` for the same query on the same (integer-valued, so
bit-exact) model; `GET /` reports status and the kernel launch count."""

import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from predictionio_tpu.ingest import BiMap
from predictionio_tpu.models import recommendation as jrec
from predictionio_tpu.ops import als as jals
from predictionio_tpu_torch.cli import main as cli
from predictionio_tpu_torch.ops import als as pals
from predictionio_tpu_torch.serving import server as srv

pytestmark = pytest.mark.torch

N_USERS, N_ITEMS, RANK = 40, 300, 16
USERS = [f"u{n}" for n in range(N_USERS)]
ITEMS = [f"i{n}" for n in range(N_ITEMS)]


def _factors():
    rng = np.random.default_rng(5)
    return (rng.integers(-4, 5, (N_USERS, RANK)).astype(np.float32),
            rng.integers(-4, 5, (N_ITEMS, RANK)).astype(np.float32))


def _queries():
    rng = np.random.default_rng(6)
    out = []
    for n in range(32):
        q = {"user": USERS[n % N_USERS], "num": int(1 + n % 10)}
        if n % 3 == 0:
            q["blackList"] = [ITEMS[j] for j in
                              rng.choice(N_ITEMS, 20, replace=False)]
        if n == 7:
            q["user"] = "ghost"
        out.append(q)
    return out


@pytest.fixture(scope="module")
def served():
    x, y = _factors()
    model = pals.als_model_from_numpy(x, y, USERS, ITEMS, device="cpu")
    server = cli.deploy(model, port=0, batch_max=64, window_s=0.02)
    yield server
    server.stop()


def _post(port, body, timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _reference(queries):
    x, y = _factors()
    model = jals.ALSModel(x, y, BiMap.from_keys(USERS),
                          BiMap.from_keys(ITEMS))
    algo = jrec.ALSAlgorithm(jrec.ALSAlgorithmParams())
    algo.warm_serving(model, [1, 2, 4, 8, 16, 32, 64])
    out = []
    for q in queries:
        (_, pred), = algo.batch_predict(model, [(0, jrec.Query(**q))])
        out.append({"itemScores": [{"item": s.item, "score": s.score}
                                   for s in pred.itemScores]})
    return out


def test_concurrent_queries_match_jax(served):
    queries = _queries()
    before = served.batcher.batch_sizes()
    barrier = threading.Barrier(len(queries))

    def fire(q):
        barrier.wait(timeout=30)
        return _post(served.port, q)

    with ThreadPoolExecutor(len(queries)) as pool:
        answers = list(pool.map(fire, queries))
    assert all(status == 200 for status, _ in answers)
    assert [body for _, body in answers] == _reference(queries)
    after = served.batcher.batch_sizes()
    grew = {n: after.get(n, 0) - before.get(n, 0) for n in after}
    assert sum(n * c for n, c in grew.items()) == len(queries)
    assert any(n > 1 and c > 0 for n, c in grew.items())


def test_status_reports_launches_and_batches(served):
    _post(served.port, {"user": "u1", "num": 3})
    with urllib.request.urlopen(
            f"http://127.0.0.1:{served.port}/", timeout=30) as resp:
        status = json.loads(resp.read())
    assert status["status"] == "alive"
    assert status["devices"] == ["cpu"]
    assert status["kernel_launches"]["fused_topk"] >= 0
    assert status["requests"] >= 1 and status["batch_sizes"]


@pytest.mark.parametrize("body,code", [
    ({"num": 3}, 400),                      # user missing
    ({"user": "u1", "bogus": 1}, 400),      # unknown field
    ({"user": "u1", "num": "x"}, 400),
])
def test_bad_queries_are_400(served, body, code):
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(served.port, body)
    assert err.value.code == code


def test_unknown_route_is_404(served):
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(f"http://127.0.0.1:{served.port}/nope",
                               timeout=30)
    assert err.value.code == 404


class _SlowDep:
    query_class = None

    def __init__(self, release: threading.Event):
        self.release = release

    def predict_batch(self, queries):
        self.release.wait(timeout=30)
        return [q * 2 for q in queries]


def test_batcher_times_out_a_stuck_drain():
    release = threading.Event()
    batcher = srv._MicroBatcher(0.001, batch_max=2, submit_timeout_s=0.2)
    with pytest.raises(srv.DeadlineExceeded):
        batcher.submit(_SlowDep(release), 1)
    release.set()
    assert batcher.close(timeout=30)


def test_batcher_bounds_its_queue():
    release = threading.Event()
    dep = _SlowDep(release)
    batcher = srv._MicroBatcher(0.001, batch_max=1, queue_max=1)
    results = []
    held = [threading.Thread(target=lambda q=q: results.append(
        batcher.submit(dep, q))) for q in (1, 2)]
    held[0].start()
    time.sleep(0.1)                        # the drainer now holds query 1
    held[1].start()
    time.sleep(0.1)                        # query 2 fills the queue
    with pytest.raises(srv.OverloadedError):
        batcher.submit(dep, 3)
    release.set()
    for th in held:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in held)
    assert sorted(results) == [2, 4]
    assert batcher.batch_sizes() == {1: 2}
    assert batcher.close(timeout=30)


def test_cli_deploy_serves_an_npz(tmp_path):
    """`python -m predictionio_tpu_torch.cli deploy` end to end: loads an
    `.npz`, warms, serves /queries.json, and exits 0 on SIGTERM."""
    import signal
    import subprocess
    import sys
    from pathlib import Path

    x, y = _factors()
    path = tmp_path / "model.npz"
    pals.als_model_from_numpy(x, y, USERS, ITEMS,
                              device="cpu").save_npz(path)
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", "deploy",
         "--model", str(path), "--port", "0", "--device", "cpu",
         "--batch-max", "8"],
        cwd=Path(__file__).resolve().parents[1], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving "), proc.stderr.read()
        port = int(line.split("http://127.0.0.1:")[1].split()[0])
        q = {"user": "u3", "num": 5, "blackList": ["i1", "i2"]}
        status, body = _post(port, q)
        assert status == 200 and body == _reference([q])[0]
    finally:
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=60)
    assert code == 0
