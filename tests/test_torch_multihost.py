"""The port's multi-process training on the CPU.

Two real processes, each holding two CPU shards, join one 4-shard mesh
through `initialize_distributed` (a `gloo` group over tcp://127.0.0.1,
from the PIO_TPU_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID env vars):
the JAX package's `tests/test_multihost.py` at half its devices. Every
process ends with the full factors, which agree with one-process
training; `cli train --num-processes 2` trains in both and writes one
engine instance, from process 0.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.cli import ops as cli_ops
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import StorageRegistry
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.parallel import MeshSpec, make_mesh

pytestmark = pytest.mark.torch

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120

# (name, als_train keywords); each run's factors go to <out>-<name>.npz
RUNS = {"rank4": {"rank": 4},
        "rank24_bf16": {"rank": 24},
        "rank24_implicit": {"rank": 24, "precision": "f32", "cg_iters": 64,
                            "implicit": True, "alpha": 2.0}}

_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.parallel import (MeshSpec,
                                                 initialize_distributed,
                                                 make_mesh)

    assert initialize_distributed(device="cpu"), "no distributed init"
    assert torch.distributed.get_world_size() == 2
    mesh = make_mesh(MeshSpec({"data": 4}), [torch.device("cpu")] * 2)
    assert mesh.size == 4 and mesh.process_count == 2
    assert mesh.local == tuple(range(2 * mesh.process_index,
                                     2 * mesh.process_index + 2))
    u, i, r = (np.load(sys.argv[1])[k] for k in ("u", "i", "r"))
    for name, kw in %r.items():
        x, y = als.als_train((u, i, np.abs(r) if kw.get("implicit") else r),
                             24, 16, iterations=3, reg=0.05, seed=2,
                             mesh=mesh, **kw)
        np.savez(f"{sys.argv[2]}-{name}.npz", x=x.numpy(), y=y.numpy())
    torch.distributed.destroy_process_group()
""" % (RUNS,))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ratings():
    rng = np.random.RandomState(0)
    n = 160
    return (rng.randint(0, 24, n).astype(np.int32),
            rng.randint(0, 16, n).astype(np.int32),
            rng.uniform(1, 5, n).astype(np.float32))


def _run_pair(argv, cwd: Path, env_extra=None) -> list:
    """Start two processes of `argv(pid)` joined over gloo; returns their
    (returncode, stdout, stderr), each bounded by TIMEOUT_S."""
    port = _free_port()
    procs = []
    for pid in range(2):
        env = {**os.environ, "PYTHONPATH": str(REPO),
               "PIO_TPU_COORDINATOR": f"127.0.0.1:{port}",
               "PIO_TPU_NUM_PROCESSES": "2",
               "PIO_TPU_PROCESS_ID": str(pid), **(env_extra or {})}
        procs.append(subprocess.Popen(
            argv(pid), env=env, cwd=str(cwd), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


class TestTwoProcessTraining:
    def test_factors_agree_with_one_process(self, tmp_path):
        u, i, r = _ratings()
        np.savez(tmp_path / "ratings.npz", u=u, i=i, r=r)
        worker = tmp_path / "worker.py"
        worker.write_text(_WORKER)
        outs = _run_pair(lambda pid: [sys.executable, str(worker),
                                      str(tmp_path / "ratings.npz"),
                                      str(tmp_path / f"p{pid}")], tmp_path)
        for code, out, err in outs:
            assert code == 0, err[-3000:]
        cpu = torch.device("cpu")
        mesh = make_mesh(MeshSpec({"data": 4}), [cpu] * 4)
        for name, kw in RUNS.items():
            v = np.abs(r) if kw.get("implicit") else r
            common = dict(iterations=3, reg=0.05, seed=2, **kw)
            x1, y1 = als.als_train((u, i, v), 24, 16, device="cpu", **common)
            xm, ym = als.als_train((u, i, v), 24, 16, mesh=mesh, **common)
            for pid in range(2):
                got = np.load(tmp_path / f"p{pid}-{name}.npz")
                assert got["x"].shape == (24, kw["rank"])
                if name == "rank24_bf16":
                    # inexact CG from a bf16 gather: the one-process mesh
                    # runs the same arithmetic
                    np.testing.assert_allclose(got["x"], xm, rtol=1e-6,
                                               atol=1e-6)
                    np.testing.assert_allclose(got["y"], ym, rtol=1e-6,
                                               atol=1e-6)
                else:
                    np.testing.assert_allclose(got["x"], x1, rtol=1e-3,
                                               atol=1e-3)
                    np.testing.assert_allclose(got["y"], y1, rtol=1e-3,
                                               atol=1e-3)

    def test_cli_train_writes_one_instance_from_process_0(self, tmp_path):
        env = {"PIO_STORAGE_SOURCES_PIO_TYPE": "SQLITE",
               "PIO_STORAGE_SOURCES_PIO_PATH": str(tmp_path / "pio.db"),
               "PIO_CPU_DEVICE_COUNT": "2"}
        registry = StorageRegistry(env)
        app = cli_ops.app_new(registry, "shop")["id"]
        u, i, r = _ratings()
        registry.get_events().insert_batch([
            Event("rate", "user", f"u{a}", "item", f"i{b}",
                  DataMap({"rating": float(c)}))
            for a, b, c in zip(u, i, r)], app)
        (tmp_path / "engine.json").write_text(json.dumps(
            {"id": "default", "engineFactory": "recommendation",
             "datasource": {"params": {"app_name": "shop"}},
             "algorithms": [{"name": "als", "params": {
                 "rank": 4, "num_iterations": 3, "lambda_": 0.05,
                 "seed": 2}}]}))
        outs = _run_pair(
            lambda pid: [sys.executable, "-m", "predictionio_tpu_torch.cli",
                         "train", "--device", "cpu", "--mesh", "data=4",
                         "--num-processes", "2", "--process-id", str(pid)],
            tmp_path, env)
        reports = []
        for code, out, err in outs:
            assert code == 0, err[-3000:]
            reports.append(json.loads(out))
        assert [(rep["distributed"], rep["persisted"]) for rep in reports] \
            == [(True, True), (True, False)]
        assert reports[1]["engineInstanceId"] == ""
        rows = StorageRegistry(env).get_meta_data_engine_instances().get_all()
        assert [row.id for row in rows] == [reports[0]["engineInstanceId"]]
        assert rows[0].status == "COMPLETED"
        assert rows[0].runtime_conf["mesh"] == "data=4"
