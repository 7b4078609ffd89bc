"""The port's serve-plane commands as subprocesses on the CPU, over one
sqlite store: `deploy --server-key` in the background, `redeploy`
(train, then POST /reload: /status.json's instance id flips while the
server keeps answering), `status`, `version`, and `undeploy` (401
without the key; with it the deploy process exits 0)."""

import json
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import predictionio_tpu_torch

pytestmark = pytest.mark.torch

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture()
def project(tmp_path):
    env = {"PIO_STORAGE_SOURCES_PIO_TYPE": "SQLITE",
           "PIO_STORAGE_SOURCES_PIO_PATH": str(tmp_path / "pio.db"),
           "PYTHONPATH": str(REPO), "PIO_OBS_LOG_LEVEL": "WARNING"}
    import os
    env = {**os.environ, **env}

    def cli(*args, check=True):
        out = subprocess.run(
            [sys.executable, "-m", "predictionio_tpu_torch.cli", *args],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=300)
        if check:
            assert out.returncode == 0, out.stderr[-3000:]
        return out

    app = json.loads(cli("app", "new", "servapp").stdout)
    rng = np.random.RandomState(0)
    with open(tmp_path / "events.jsonl", "w") as f:
        for u in range(20):
            for i in range(15):
                if rng.rand() > 0.5:
                    continue
                f.write(json.dumps({
                    "event": "rate", "entityType": "user",
                    "entityId": f"u{u}", "targetEntityType": "item",
                    "targetEntityId": f"i{i}",
                    "properties": {"rating": 5 if i % 3 == u % 3
                                   else 1}}) + "\n")
    cli("import", "--appid", str(app["id"]), "--input", "events.jsonl")
    (tmp_path / "engine.json").write_text(json.dumps({
        "id": "srv", "engineFactory": "recommendation",
        "datasource": {"params": {"app_name": "servapp"}},
        "algorithms": [{"name": "als", "params": {
            "rank": 4, "num_iterations": 2, "seed": 1}}]}))
    first = json.loads(cli("train", "--device", "cpu").stdout)
    return tmp_path, env, cli, first["engineInstanceId"]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return json.loads(resp.read())


def _query(port):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=b'{"user": "u1", "num": 3}', method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def test_redeploy_status_version_undeploy(project):
    tmp, env, cli, first = project
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", "deploy",
         "--device", "cpu", "--port", "0", "--batch-max", "8",
         "--server-key", "sekrit"], cwd=tmp, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith(f"serving engine instance {first} on ")
        port = int(line.split("http://127.0.0.1:")[1].split()[0])
        assert _get(port, "/status.json")["engineInstanceId"] == first
        assert _query(port)[0] == 200

        out = cli("redeploy", "--device", "cpu", "--port", str(port),
                  "--accesskey", "sekrit")
        second = json.loads(out.stdout[:out.stdout.rindex("}") + 1])[
            "engineInstanceId"]
        assert out.stdout.strip().endswith("Reloaded") and second != first
        status = _get(port, "/status.json")
        assert status["engineInstanceId"] == second
        assert status["engineVariant"] == "srv"
        code, body = _query(port)
        assert code == 200 and len(body["itemScores"]) == 3

        info = json.loads(cli("status").stdout)
        assert info["version"] == predictionio_tpu_torch.__version__
        assert info["storage"] == "ok" and info["platform"] in ("cpu",
                                                                 "cuda")
        assert info["latestTrainedInstance"]["id"] == second
        assert cli("version").stdout.strip() == \
            predictionio_tpu_torch.__version__

        denied = cli("undeploy", "--port", str(port), check=False)
        assert denied.returncode == 1 and "Unauthorized" in denied.stderr
        assert proc.poll() is None
        out = cli("undeploy", "--port", str(port), "--accesskey", "sekrit")
        assert out.stdout.strip() == "Undeployed"
        assert proc.wait(timeout=30) == 0
        gone = cli("undeploy", "--port", str(port), "--accesskey",
                   "sekrit", check=False)
        assert gone.returncode == 1 and "No server" in gone.stdout
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
