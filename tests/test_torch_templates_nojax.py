"""The port's finish line: in a process where `import jax` and `import
predictionio_tpu` fail, every bundled template trains, deploys behind
the HTTP server and answers a `/queries.json` on the CPU, at tiny sizes
(`build` -> `run_train` -> `deploy_instance` -> one query). And `cli
template new` scaffolds an engine directory for each of the six bases
that `build` accepts; the twotower and seqrec scaffolds also train,
deploy and answer."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.torch

REPO = Path(__file__).resolve().parents[1]

PRELUDE = """
import json, sys, urllib.request
from datetime import datetime, timedelta, timezone
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
from predictionio_tpu_torch.cli import ops
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import App, StorageRegistry

T0 = datetime(2024, 1, 1, tzinfo=timezone.utc)


def store(app_name, kind):
    reg = StorageRegistry({
        "PIO_STORAGE_SOURCES_MEM_TYPE": "MEM",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"})
    app = reg.get_meta_data_apps().insert(App(0, app_name))
    events = reg.get_events()
    events.init(app)
    rng = np.random.RandomState(0)
    batch = []
    if kind == "classification":
        for i in range(60):
            plan = i % 2
            batch.append(Event(
                event="$set", entity_type="user", entity_id=f"u{i}",
                properties=DataMap({
                    "attr0": int(rng.poisson(7 if plan == 0 else 1)),
                    "attr1": int(rng.poisson(2)),
                    "attr2": int(rng.poisson(7 if plan else 1)),
                    "plan": float(plan)})))
    else:
        # 20 users x 15 items, each user on the items of its residue
        for u in range(20):
            for i in range(15):
                if i % 3 != u % 3:
                    continue
                name = {"recommendation": "rate"}.get(kind, "view")
                props = {"rating": float(1 + (u + i) % 5)} \\
                    if name == "rate" else {}
                batch.append(Event(
                    event=name, entity_type="user", entity_id=f"u{u}",
                    target_entity_type="item", target_entity_id=f"i{i}",
                    properties=DataMap(props),
                    event_time=T0 + timedelta(seconds=len(batch))))
                if kind == "ecommerce" and i < 3:
                    batch.append(Event(
                        event="buy", entity_type="user", entity_id=f"u{u}",
                        target_entity_type="item", target_entity_id=f"i{i}",
                        properties=DataMap({}),
                        event_time=T0 + timedelta(seconds=len(batch))))
    for s in range(0, len(batch), 50):
        events.insert_batch(batch[s:s + 50], app)
    return reg


def serve_one(engine, row, reg, query):
    server = cli_main.deploy_instance(
        engine, row, RuntimeContext(registry=reg, device="cpu"), port=0)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/queries.json",
            data=json.dumps(query).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())
    finally:
        server.stop()


def loaded():
    return sorted(m for m, v in sys.modules.items() if v is not None
                  and m.split(".")[0] in ("jax", "predictionio_tpu"))
"""

TEMPLATE = PRELUDE + """
from predictionio_tpu_torch.core.workflow import CoreWorkflow, resolve_engine

spec = json.loads(sys.argv[1])
reg = store("app", spec["factory"])
variant = {"id": "default", "engineFactory": spec["factory"],
           "datasource": {"params": {"app_name": "app"}},
           "algorithms": [{"name": spec["algorithm"],
                           "params": spec["params"]}]}
with open(sys.argv[2], "w") as f:
    json.dump(variant, f)
built = ops.build(sys.argv[2])
engine = resolve_engine(spec["factory"])
ctx = RuntimeContext(registry=reg, device="cpu")
row = CoreWorkflow.run_train(engine,
                             engine.engine_params_from_variant(variant), ctx,
                             engine_factory=spec["factory"])
answer = serve_one(engine, row, reg, spec["query"])
print(json.dumps({"built": built["engineFactory"], "status": row.status,
                  "answer": answer, "loaded": loaded()}))
"""

CASES = {
    "recommendation": ("als", {"rank": 4, "num_iterations": 3, "seed": 1},
                       {"user": "u1", "num": 3}),
    "ecommerce": ("ecomm", {"app_name": "app", "rank": 4,
                            "num_iterations": 3, "seed": 1},
                  {"user": "u1", "num": 3}),
    "similarproduct": ("als", {"rank": 4, "num_iterations": 3, "seed": 1},
                       {"items": ["i1"], "num": 3}),
    "classification": ("naive", {}, {"attr0": 8, "attr1": 2, "attr2": 0}),
    "twotower": ("twotower", {"emb_dim": 8, "hidden": 8, "out_dim": 8,
                              "batch_size": 16, "epochs": 2, "seed": 1},
                 {"user": "u1", "num": 3}),
    "seqrec": ("seqrec", {"app_name": "app", "seq_len": 4, "dim": 8,
                          "n_heads": 2, "n_layers": 1, "batch_size": 8,
                          "epochs": 2, "seed": 1},
               {"user": "u1", "num": 3}),
}


@pytest.mark.parametrize("factory", sorted(CASES))
def test_every_template_trains_deploys_and_serves_without_jax(factory,
                                                              tmp_path):
    algorithm, params, query = CASES[factory]
    spec = {"factory": factory, "algorithm": algorithm, "params": params,
            "query": query}
    out = subprocess.run(
        [sys.executable, "-c", TEMPLATE, json.dumps(spec),
         str(tmp_path / "engine.json")], cwd=REPO, capture_output=True,
        text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["built"] == factory and got["status"] == "COMPLETED"
    assert got["loaded"] == []
    if factory == "classification":
        assert got["answer"] == {"label": 0.0}
    else:
        assert len(got["answer"]["itemScores"]) == 3, got["answer"]


SCAFFOLD = PRELUDE + """
import os

root = sys.argv[1]
out = {}
for base in ("recommendation", "similarproduct", "classification",
             "ecommerce", "twotower", "seqrec"):
    d = os.path.join(root, base)
    assert cli_main.main(["template", "new", d, "--base", base]) == 0
    os.chdir(d)
    sys.path.insert(0, d)
    sys.modules.pop("my_engine", None)
    result = {"build": ops.build("engine.json")["engineFactory"],
              "algo_params": json.load(open("engine.json"))[
                  "algorithms"][0]["params"]}
    if base in ("twotower", "seqrec"):
        reg = store("myapp", base)
        trained = ops.train(reg, engine_json="engine.json", device="cpu")
        engine, row = ops.deploy_target(reg, engine_json="engine.json")
        result["status"] = trained["status"]
        result["factory"] = row.engine_factory
        result["answer"] = serve_one(engine, row, reg,
                                     {"user": "u1", "num": 3})
    sys.path.remove(d)
    out[base] = result
print(json.dumps({"bases": out, "loaded": loaded()}))
"""


def test_template_new_scaffolds_every_base_and_the_neural_ones_serve(
        tmp_path):
    """`cli template new --base <each>` writes an engine directory that
    `build` accepts (app_name in the algorithm params of the two bases
    that read the store at serve time); the twotower and seqrec scaffolds
    train, deploy and answer through their `my_engine.engine` path."""
    out = subprocess.run([sys.executable, "-c", SCAFFOLD, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=240,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["loaded"] == []
    bases = got["bases"]
    assert sorted(bases) == sorted(CASES)
    for base, r in bases.items():
        assert r["build"] == "my_engine.engine", base
        assert r["algo_params"] == ({"app_name": "myapp"} if base in (
            "ecommerce", "seqrec") else {}), base
    for base in ("twotower", "seqrec"):
        r = bases[base]
        assert r["status"] == "COMPLETED" and \
            r["factory"] == "my_engine.engine"
        assert len(r["answer"]["itemScores"]) == 3, r


def test_template_new_refuses_an_unknown_base_or_a_full_directory(tmp_path):
    from predictionio_tpu_torch.cli import ops
    with pytest.raises(ValueError, match="Unknown base template"):
        ops.template_new(str(tmp_path / "x"), base="nope")
    (tmp_path / "full").mkdir()
    (tmp_path / "full" / "f").write_text("")
    with pytest.raises(ValueError, match="not empty"):
        ops.template_new(str(tmp_path / "full"), base="twotower")
