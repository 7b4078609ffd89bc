"""The port's multi-process training on the CPU.

Two real processes, each holding two CPU shards, join one 4-shard mesh
through `initialize_distributed` (a `gloo` group over tcp://127.0.0.1,
from the PIO_TPU_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID env vars):
the JAX package's `tests/test_multihost.py` at half its devices. Every
process ends with the full factors, which agree with one-process
training; `cli train --num-processes 2` trains in both and writes one
engine instance, from process 0.

The classifiers over "data" = 4 split the same way: the forest equals
the one-process forest exactly, NB within rtol 1e-5 and logistic
regression within rtol 5e-3 / atol 5e-4 (the classification tests'
bars). Two-tower over data=2 x model=2 and seqrec over data=2 x sp=2,
each process holding one data group whose "model" or "sp" shards stay
inside it, meet the one-process mesh within 1e-5 (their step losses
within rtol 1e-5). A mesh whose "model" or "sp" axis spans the two
processes raises NotImplementedError in both.
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


_CLASSIFY = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from predictionio_tpu_torch.ops import forest, logreg, naive_bayes
    from predictionio_tpu_torch.parallel import (MeshSpec,
                                                 initialize_distributed,
                                                 make_mesh)

    assert initialize_distributed(device="cpu"), "no distributed init"
    mesh = make_mesh(MeshSpec({"data": 4}), [torch.device("cpu")] * 2)
    d = np.load(sys.argv[1])
    f = forest.forest_train(d["x"], d["y"], n_trees=5, max_depth=4, seed=2,
                            mesh=mesh)
    nb = naive_bayes.nb_train(d["xi"], d["y"], 1.0, mesh=mesh)
    lr = logreg.logreg_train(d["x"], d["y"], steps=50, mesh=mesh)
    np.savez(sys.argv[2], split_feature=f.split_feature,
             split_bin=f.split_bin, leaf_class=f.leaf_class, pi=nb.pi,
             theta=nb.theta, w=lr.w, b=lr.b)
    torch.distributed.destroy_process_group()
""")

_NEURAL = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from predictionio_tpu_torch.ops import seqrec, twotower
    from predictionio_tpu_torch.parallel import (Mesh, MeshSpec,
                                                 initialize_distributed,
                                                 make_mesh)

    assert initialize_distributed(device="cpu"), "no distributed init"
    cpu = torch.device("cpu")
    d = np.load(sys.argv[1])
    out = {}
    tt_losses, sr_losses = [], []
    tt = twotower.twotower_train(
        d["u"], d["i"], n_users=40, n_items=32, emb_dim=8, hidden=16,
        out_dim=8, batch_size=64, epochs=2, seed=3, step_losses=tt_losses,
        mesh=make_mesh(MeshSpec({"data": 2, "model": 2}), [cpu] * 2))
    out.update({f"tt_{k}": v for k, v in tt.params.items()},
               tt_user=tt.user_emb, tt_losses=[float(x) for x in tt_losses])
    sr = seqrec.seqrec_train(
        d["seqs"], d["targets"], n_items=30, seq_len=8, dim=16, n_heads=2,
        n_layers=1, batch_size=32, epochs=2, seed=3, step_losses=sr_losses,
        mesh=make_mesh(MeshSpec({"data": 2, "sp": 2}), [cpu] * 2))
    out.update(sr_table=sr.params["item_table"], sr_wq=sr.params["l0"]["wq"],
               sr_losses=[float(x) for x in sr_losses])
    refused = 0
    for axis in ("model", "sp"):
        spanning = make_mesh(MeshSpec({axis: 2, "data": 2}), [cpu] * 2)
        try:
            if axis == "model":
                twotower.twotower_train(d["u"], d["i"], n_users=40,
                                        n_items=32, batch_size=64,
                                        epochs=1, mesh=spanning)
            else:
                seqrec.seqrec_train(d["seqs"], d["targets"], n_items=30,
                                    seq_len=8, dim=16, batch_size=32,
                                    epochs=1, mesh=spanning)
        except NotImplementedError:
            refused += 1
    out["refused"] = refused
    np.savez(sys.argv[2], **out)
    torch.distributed.destroy_process_group()
""")


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


class TestTwoProcessMeshTemplates:
    def test_classifiers_over_data_agree_with_one_process(self, tmp_path):
        from predictionio_tpu_torch.ops import forest, logreg, naive_bayes
        rng = np.random.RandomState(3)
        x = rng.randn(601, 8).astype(np.float32)
        y = ((x[:, 0] + 0.5 * x[:, 3] > 0).astype(np.float32)
             + (x[:, 1] > 1).astype(np.float32))
        xi = rng.randint(0, 5, (601, 4)).astype(np.float32)
        np.savez(tmp_path / "data.npz", x=x, y=y, xi=xi)
        worker = tmp_path / "classify.py"
        worker.write_text(_CLASSIFY)
        outs = _run_pair(lambda pid: [sys.executable, str(worker),
                                      str(tmp_path / "data.npz"),
                                      str(tmp_path / f"c{pid}.npz")],
                         tmp_path)
        for code, out, err in outs:
            assert code == 0, err[-3000:]
        f = forest.forest_train(x, y, n_trees=5, max_depth=4, seed=2,
                                device="cpu")
        nb = naive_bayes.nb_train(xi, y, 1.0, device="cpu")
        lr = logreg.logreg_train(x, y, steps=50, device="cpu")
        for pid in range(2):
            got = np.load(tmp_path / f"c{pid}.npz")
            for name in ("split_feature", "split_bin", "leaf_class"):
                np.testing.assert_array_equal(got[name], getattr(f, name))
            np.testing.assert_allclose(got["pi"], nb.pi, rtol=1e-5)
            np.testing.assert_allclose(got["theta"], nb.theta, rtol=1e-5)
            np.testing.assert_allclose(got["w"], lr.w, rtol=5e-3, atol=5e-4)

    def test_neural_templates_over_model_and_sp_inside_each_process(
            self, tmp_path):
        from predictionio_tpu_torch.ops import seqrec, twotower
        rng = np.random.RandomState(4)
        u = rng.randint(0, 40, 256).astype(np.int32)
        i = rng.randint(0, 32, 256).astype(np.int32)
        seqs = rng.randint(0, 30, (128, 8)).astype(np.int32)
        seqs[:, :3] = 30
        targets = rng.randint(0, 30, 128).astype(np.int32)
        np.savez(tmp_path / "data.npz", u=u, i=i, seqs=seqs,
                 targets=targets)
        worker = tmp_path / "neural.py"
        worker.write_text(_NEURAL)
        outs = _run_pair(lambda pid: [sys.executable, str(worker),
                                      str(tmp_path / "data.npz"),
                                      str(tmp_path / f"n{pid}.npz")],
                         tmp_path)
        for code, out, err in outs:
            assert code == 0, err[-3000:]
        cpu = torch.device("cpu")
        tt_losses, sr_losses = [], []
        tt = twotower.twotower_train(
            u, i, n_users=40, n_items=32, emb_dim=8, hidden=16, out_dim=8,
            batch_size=64, epochs=2, seed=3, step_losses=tt_losses,
            mesh=make_mesh(MeshSpec({"data": 2, "model": 2}), [cpu] * 4))
        sr = seqrec.seqrec_train(
            seqs, targets, n_items=30, seq_len=8, dim=16, n_heads=2,
            n_layers=1, batch_size=32, epochs=2, seed=3,
            step_losses=sr_losses,
            mesh=make_mesh(MeshSpec({"data": 2, "sp": 2}), [cpu] * 4))
        for pid in range(2):
            got = np.load(tmp_path / f"n{pid}.npz")
            assert int(got["refused"]) == 2
            np.testing.assert_allclose(got["tt_losses"],
                                       [float(x) for x in tt_losses],
                                       rtol=1e-5)
            for k, v in tt.params.items():
                np.testing.assert_allclose(got[f"tt_{k}"], v, atol=1e-5,
                                           err_msg=k)
            np.testing.assert_allclose(got["tt_user"], tt.user_emb,
                                       atol=1e-5)
            np.testing.assert_allclose(got["sr_losses"],
                                       [float(x) for x in sr_losses],
                                       rtol=1e-5)
            np.testing.assert_allclose(got["sr_table"],
                                       sr.params["item_table"], atol=1e-5)
            np.testing.assert_allclose(got["sr_wq"], sr.params["l0"]["wq"],
                                       atol=1e-5)
