"""Import and device rules of the port: `predictionio_tpu_torch` loads
neither jax nor any module of `predictionio_tpu`; its entry points run
on CUDA unless asked for the CPU and raise without CUDA; the fused-kernel
wrapper and the sharded plan never answer a non-CPU request with the
plain version."""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import predictionio_tpu_torch
from predictionio_tpu_torch import device as pdev
from predictionio_tpu_torch.ops import als as pals
from predictionio_tpu_torch.ops import fused_topk
from predictionio_tpu_torch.ops import topk as pt

pytestmark = pytest.mark.torch

REPO = Path(__file__).resolve().parents[1]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        predictionio_tpu_torch.__path__, "predictionio_tpu_torch."))


def test_every_module_imports_without_jax_or_the_jax_package():
    mods = _modules()
    assert "predictionio_tpu_torch.ops.fused_topk" in mods
    assert "predictionio_tpu_torch.serving.server" in mods
    for required in ("ops.topk_sharded", "ops.topk_tiered",
                     "parallel.mesh", "serving.paging", "ops.linalg",
                     "ingest.arrays", "core.runtime", "data.event",
                     "data.integrity", "data.store", "data.storage.base",
                     "data.storage.columns", "data.storage.memory",
                     "data.storage.sqlite", "data.storage.registry",
                     "ingest.pipeline", "core.persistence", "cli.ops",
                     "native", "native.eventlog", "data.storage.evlog",
                     "data.storage.pevlog", "data.storage._scanworker",
                     "streaming", "streaming.delta", "streaming.updaters",
                     "streaming.refresher", "utils.http", "data.plugins",
                     "data.stats", "data.webhooks",
                     "data.webhooks.connectors", "data.eventserver",
                     "resilience", "resilience.retry", "core.evaluation",
                     "core.batchpredict", "e2", "e2.engine",
                     "e2.evaluation", "data.aggregate", "ops.cooccur",
                     "models.common", "models.ecommerce",
                     "models.similarproduct", "ops.naive_bayes",
                     "ops.logreg", "ops.forest", "models.classification",
                     "ops.adam", "ops.attention", "ops.twotower",
                     "ops.seqrec", "models.twotower", "models.seqrec",
                     "utils.wire", "utils.security", "obs", "obs.metrics",
                     "obs.logs", "obs.report", "resilience.deadline",
                     "resilience.shed", "resilience.faults",
                     "serving.plugins"):
        assert f"predictionio_tpu_torch.{required}" in mods
    code = (
        "import importlib, json, sys\n"
        f"mods = {[m for m in mods if not m.endswith('__main__')]!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' "
        "or n.startswith('jax.') or n == 'predictionio_tpu' "
        "or n.startswith('predictionio_tpu.'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    from predictionio_tpu_torch import ingest
    for name in ("LabeledPoints", "labeled_points_from_properties",
                 "RatingColumns", "BiMap"):
        assert hasattr(ingest, name), name


NO_JAX_TEMPLATE = """
import json, sys, urllib.request
sys.modules["jax"] = None                 # `import jax` now raises
sys.modules["predictionio_tpu"] = None
try:
    import jax  # noqa: F401
except ImportError:
    pass
else:
    raise SystemExit("jax imported")
import numpy as np
from predictionio_tpu_torch.cli import main as cli_main
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.core.workflow import CoreWorkflow, resolve_engine
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import App, StorageRegistry

reg = StorageRegistry({"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM",
                       "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
                       "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
                       "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"})
app = reg.get_meta_data_apps().insert(App(0, "clf"))
reg.get_events().init(app)
rng = np.random.RandomState(0)
for i in range(60):
    plan = i % 2
    reg.get_events().insert(Event(
        event="$set", entity_type="user", entity_id=f"u{i}",
        properties=DataMap({"attr0": int(rng.poisson(7 if plan == 0 else 1)),
                            "attr1": int(rng.poisson(2)),
                            "attr2": int(rng.poisson(7 if plan else 1)),
                            "plan": float(plan)})), app)
ctx = RuntimeContext(registry=reg, device="cpu")
engine = resolve_engine("classification")
params = engine.engine_params_from_variant({
    "datasource": {"params": {"app_name": "clf"}},
    "algorithms": [{"name": "forest", "params": {"num_trees": 4,
                                                 "max_depth": 3}},
                   {"name": "naive", "params": {}},
                   {"name": "logreg", "params": {"steps": 50}}]})
row = CoreWorkflow.run_train(engine, params, ctx,
                             engine_factory="classification")
server = cli_main.deploy_instance(engine, row, ctx, port=0)
try:
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}/queries.json",
        data=json.dumps({"attr0": 8, "attr1": 2, "attr2": 0}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        body = json.loads(resp.read())
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/metrics", timeout=60) as resp:
        metrics = resp.read().decode()
finally:
    server.stop()
served = [ln for ln in metrics.splitlines() if ln.startswith(
    'pio_http_requests_total{route="/queries.json"')]
print(json.dumps({"status": row.status, "answer": body, "loaded": sorted(
    m for m, v in sys.modules.items() if v is not None
    and m.split(".")[0] in ("jax", "predictionio_tpu")),
    "wire": server.wire, "served": served}))
"""


def test_classification_trains_deploys_and_serves_without_jax():
    """The port's finish line for one template: in a process where
    `import jax` fails, the classification template (forest, naive,
    logreg) trains, deploys behind the HTTP server on the selector wire,
    answers a query on `device="cpu"` and counts it on `/metrics`."""
    out = subprocess.run([sys.executable, "-c", NO_JAX_TEMPLATE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"status": "COMPLETED", "answer": {"label": 0.0},
                   "loaded": [], "wire": "selector",
                   "served": ['pio_http_requests_total{route='
                              '"/queries.json",method="POST",'
                              'status="200"} 1']}


def test_the_scan_worker_loads_neither_torch_nor_jax():
    """PEVLOG's spawn-started scan workers import the worker module and
    what it reaches when it runs: no torch, no device code, no jax."""
    code = (
        "import json, sys\n"
        "from predictionio_tpu_torch.data.storage import _scanworker\n"
        "from predictionio_tpu_torch.data.storage.columns import "
        "BlockBuilder\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('torch', 'jax', 'predictionio_tpu') or n.startswith("
        "'predictionio_tpu_torch.ops') or n == "
        "'predictionio_tpu_torch.device')\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_resolve_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pdev.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pdev.resolve_device("cuda:0")
    assert pdev.resolve_device("cpu") == torch.device("cpu")


def test_entry_points_refuse_to_carry_on_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.ones((2, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pals.als_model_from_numpy(x, x, ["a", "b"], ["c", "d"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.BucketedTopK(x, k=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.topk_scores(x, x, np.ones((2, 2), bool), k=1)


def test_wrapper_never_runs_plain_version_off_cpu(monkeypatch):
    def forbidden(*a, **kw):
        raise AssertionError("plain version ran for a non-CPU tensor")

    monkeypatch.setattr(fused_topk, "fused_topk_reference", forbidden)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_topk.fused_topk(torch.empty((1, 4), **meta),
                              torch.empty((8, 4), **meta),
                              torch.empty((1, 2), dtype=torch.int32, **meta),
                              k=2, n_valid=8)


def test_sharded_plan_never_runs_plain_version_off_cpu(monkeypatch):
    """A shard on a device the kernel does not serve raises; nothing
    routes the sharded plan around the kernel."""
    from predictionio_tpu_torch.ops import topk_sharded as ps

    def forbidden(*a, **kw):
        raise AssertionError("plain version ran for a non-CPU tensor")

    monkeypatch.setattr(fused_topk, "fused_topk_reference", forbidden)
    plan = ps.ShardedBucketedTopK(
        np.ones((10, 4), np.float32), k=2, buckets=(1,), banned_width=2,
        mesh=ps.ServeMesh(("meta",) * 2, forced=True))
    with pytest.raises(ValueError, match="no kernel for device"):
        plan.warm()
    before = fused_topk.SHARD_LAUNCHES
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_topk.shard_local_candidates(
            torch.empty((1, 4), device="meta"),
            torch.empty((8, 4), device="meta"),
            torch.empty((1, 2), dtype=torch.int32, device="meta"),
            k=2, n_valid=8)
    assert fused_topk.SHARD_LAUNCHES == before


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(fused_topk, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(fused_topk, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(fused_topk, "_LIB", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fused_topk.load_library()
    assert not (tmp_path / "build").exists()


def test_kernel_build_failure_raises(monkeypatch, tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: bad kernel' >&2\nexit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(fused_topk, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc failed with code 2"):
        fused_topk.build_library()
    logs = list((tmp_path / "build").glob("*.log"))
    assert len(logs) == 1 and "bad kernel" in logs[0].read_text()
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("bad,match", [
    (dict(k=65), "outside 1..64"),
    (dict(n_valid=9), "outside 0..n_rows"),
    (dict(vecs_dtype=torch.float64), "float32"),
    (dict(bucket=129), "outside 1..128"),
])
def test_wrapper_checks_before_launch(bad, match):
    b = bad.get("bucket", 2)
    vecs = torch.zeros((b, 4), dtype=bad.get("vecs_dtype", torch.float32))
    factors = torch.zeros((8, 4))
    banned = torch.zeros((b, 2), dtype=torch.int32)
    with pytest.raises((ValueError, TypeError), match=match):
        fused_topk._check(vecs, factors, banned, bad.get("k", 2),
                          bad.get("n_valid", 8))
