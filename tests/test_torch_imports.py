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
                     "serving.plugins", "tenancy", "tenancy.admission",
                     "tenancy.drr", "obs.slo", "resilience.watchdog",
                     "serving.fleet", "serving.supervisor",
                     "resilience.breaker", "resilience.budget",
                     "data.storage.resilient", "data.storage.localfs",
                     "data.storage.pgwire", "data.storage.postgres",
                     "data.storage.objectstore", "data.storage.replicated",
                     "data.fsck", "ingest.blockproto", "ingest.client",
                     "ingest.service", "data.view", "data.entitymap",
                     "core.selfclean", "core.fakeworkflow", "obs.trace",
                     "obs.tsdb", "obs.profiler", "obs.kernelprobe",
                     "obs.quality", "resilience.pressure",
                     "serving.autoscaler", "tools.dashboard",
                     "tools.loadsim", "resilience.scenarios",
                     "tools.admin", "cli.service"):
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


OBSERVED_NO_JAX = """
import json, sys, urllib.request
sys.modules["jax"] = None                 # `import jax` now raises
sys.modules["predictionio_tpu"] = None
import numpy as np
import torch
from predictionio_tpu_torch.cli import main as cli_main
from predictionio_tpu_torch.obs import get_profiler, trace
from predictionio_tpu_torch.ops import als

rng = np.random.default_rng(1)
model = als.als_model_from_numpy(
    rng.integers(-3, 4, (6, 4)).astype(np.float32),
    rng.integers(-3, 4, (30, 4)).astype(np.float32),
    [f"u{n}" for n in range(6)], [f"i{n}" for n in range(30)],
    device="cpu")
server = cli_main.deploy(model, port=0, batch_max=4)
base = f"http://127.0.0.1:{server.port}"
try:
    for n in range(6):
        req = urllib.request.Request(
            base + "/queries.json",
            data=json.dumps({"user": f"u{n}", "num": 3}).encode(),
            headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=30).read()
    import time
    end = time.monotonic() + 10
    while time.monotonic() < end and sum(
            e["kind"] == "serve" for e in trace.get_recorder().snapshot()) < 6:
        time.sleep(0.01)
    get_profiler().sample_once()
    server._scraper.tick()
    got = {}
    for path in ("/traces.json", "/tsdb.json", "/profile.json"):
        with urllib.request.urlopen(base + path, timeout=30) as resp:
            got[path] = json.loads(resp.read())
finally:
    server.stop()
print(json.dumps({
    "traces": sum(e["kind"] == "serve"
                  for e in got["/traces.json"]["traces"]),
    "series": sorted(got["/tsdb.json"]["series"]),
    "samples": got["/profile.json"]["samples"],
    "profiler_running": get_profiler().running,
    "cuda_initialized": torch.cuda.is_initialized(),
    "loaded": sorted(m for m, v in sys.modules.items() if v is not None
                     and m.split(".")[0] in ("jax", "predictionio_tpu"))}))
"""


def test_tracing_the_scraper_and_the_profiler_run_without_jax():
    """A port server with tracing at sample 1, its scraper and the
    process's sampling profiler running, in a process where `import jax`
    and `import predictionio_tpu` fail: it traces, scrapes and samples,
    loads neither, and makes no CUDA context."""
    import os
    env = {**os.environ, "PIO_TRACE_SAMPLE": "1", "PIO_TSDB_INTERVAL_S":
           "0.05", "PIO_PROF_HZ": "50"}
    out = subprocess.run([sys.executable, "-c", OBSERVED_NO_JAX], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["loaded"] == [] and got["cuda_initialized"] is False
    assert got["traces"] == 6 and got["samples"] > 0
    assert got["profiler_running"] is True
    assert "pio_host_rss_bytes" in got["series"]


QUALITY_GUARD_NO_JAX = """
import json, sys, urllib.request
sys.modules["jax"] = None                 # `import jax` now raises
sys.modules["predictionio_tpu"] = None
import numpy as np
import torch
from predictionio_tpu_torch.cli import main as cli_main
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.resilience import faults, watchdog

rng = np.random.default_rng(1)
model = als.als_model_from_numpy(
    rng.integers(-3, 4, (6, 4)).astype(np.float32),
    rng.integers(-3, 4, (30, 4)).astype(np.float32),
    [f"u{n}" for n in range(6)], [f"i{n}" for n in range(30)],
    device="cpu")
server = cli_main.deploy(model, port=0, batch_max=4)
base = f"http://127.0.0.1:{server.port}"

def post():
    req = urllib.request.Request(
        base + "/queries.json",
        data=json.dumps({"user": "u1", "num": 3}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        return urllib.request.urlopen(req, timeout=30).status
    except urllib.error.HTTPError as e:
        return e.code

try:
    codes = [post() for _ in range(5)]
    with urllib.request.urlopen(base + "/quality.json", timeout=30) as r:
        quality = json.loads(r.read())
    guarded = server._pressure in watchdog()._guards
    faults().arm("mem.pressure.soft", times=1)
    state = server._pressure.check()
    codes.append(post())
    roles = sorted({b.role for b in watchdog().beats()})
finally:
    server.stop()
print(json.dumps({
    "codes": codes, "n": quality["apps"][""]["n"], "state": state,
    "guarded": guarded, "roles": roles,
    "cuda_initialized": torch.cuda.is_initialized(),
    "loaded": sorted(m for m, v in sys.modules.items() if v is not None
                     and m.split(".")[0] in ("jax", "predictionio_tpu"))}))
"""


def test_quality_and_the_memory_guard_run_without_jax():
    """A port server with quality on and its memory guard on the
    watchdog's sweep, in a process where `import jax` and `import
    predictionio_tpu` fail: it counts every answer in `/quality.json`,
    sheds at the soft watermark, loads neither and makes no CUDA
    context."""
    out = subprocess.run([sys.executable, "-c", QUALITY_GUARD_NO_JAX],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["loaded"] == [] and got["cuda_initialized"] is False
    assert got["codes"] == [200] * 5 + [503]
    assert got["n"] == 5 and got["state"] == "soft" and got["guarded"]
    assert "reactor" in got["roles"]


def test_a_supervised_child_runs_the_ports_cli_without_jax():
    """`child_argv_from_parent` names the port's CLI, and that argv's
    module parses the child's deploy flags in a process where `import
    jax` and `import predictionio_tpu` fail (so do the stub child's)."""
    from predictionio_tpu_torch.serving.supervisor import (
        child_argv_from_parent, stub_child_argv)
    argv = child_argv_from_parent(
        ["deploy", "--supervised", "2", "--device", "cpu", "--port", "9"],
        "http://127.0.0.1:9", extra=("--member-name", "replica0"))
    assert argv[1:3] == ["-m", "predictionio_tpu_torch.cli"]
    assert stub_child_argv("http://127.0.0.1:9")[1:3] == [
        "-m", "predictionio_tpu_torch.serving.supervisor"]
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['predictionio_tpu'] = None\n"
        f"sys.argv = ['x', *{argv[3:]!r}, '--help']\n"
        f"runpy.run_module({argv[2]!r}, run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--join" in out.stdout and "--supervised" in out.stdout


def test_the_storage_drivers_and_doctor_run_without_jax(tmp_path):
    """POSTGRES (over `tests/fakepg.py`, loaded by path as
    `chip_smoke.py` loads it), REPLICATED LOCALFS, the resilience proxy
    and `doctor` in a process where `import jax` and `import
    predictionio_tpu` fail."""
    code = (
        "import importlib.util, json, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['predictionio_tpu'] = None\n"
        "spec = importlib.util.spec_from_file_location('fakepg', "
        f"{str(REPO / 'tests' / 'fakepg.py')!r})\n"
        "fakepg = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(fakepg)\n"
        "from predictionio_tpu_torch.data.storage import (App, Model,\n"
        "    StorageRegistry)\n"
        "from predictionio_tpu_torch.data import fsck\n"
        "with fakepg.FakePgServer() as url:\n"
        "    cfg = {'PIO_STORAGE_SOURCES_PG_TYPE': 'POSTGRES',\n"
        "           'PIO_STORAGE_SOURCES_PG_URL': url,\n"
        "           'PIO_STORAGE_SOURCES_REP_TYPE': 'REPLICATED',\n"
        "           'PIO_STORAGE_SOURCES_REP_REPLICAS': 'A,B',\n"
        "           'PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE': 'REP',\n"
        "           'PIO_STORAGE_REPOSITORIES_METADATA_SOURCE': 'PG',\n"
        "           'PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE': 'PG'}\n"
        "    for t in 'AB':\n"
        "        cfg[f'PIO_STORAGE_SOURCES_{t}_TYPE'] = 'LOCALFS'\n"
        f"        cfg[f'PIO_STORAGE_SOURCES_{{t}}_PATH'] = {str(tmp_path)!r}"
        " + '/' + t\n"
        "    reg = StorageRegistry(cfg)\n"
        "    aid = reg.get_meta_data_apps().insert(App(0, 'a'))\n"
        "    reg.get_model_data_models().insert(Model('m', b'x'))\n"
        "    report = fsck.doctor(reg, repair=True)\n"
        "    reg.close()\n"
        "bad = sorted(n for n in sys.modules if n.startswith(('jax.', "
        "'predictionio_tpu.')))\n"
        "print(json.dumps([aid, report['unrepaired'], bad]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [1, 0, []]


def test_chip_smoke_imports_only_the_port_and_fakepg():
    import ast
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    roots = {n.split(".")[0] for n in names}
    assert "jax" not in roots and "predictionio_tpu" not in roots
    assert "tests" not in roots          # fakepg is loaded by its path
    assert "predictionio_tpu_torch" in roots
    assert '"fakepg.py"' in (REPO / "chip_smoke.py").read_text()


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
