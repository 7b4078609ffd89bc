"""The port's ALS over a device mesh (`ops.als` sharded loop,
`parallel.mesh`) against its own single-device loop and the JAX
package's sharded program, on the CPU.

- `_pack_by_owner` is byte-equal to the JAX package's; `MeshSpec`
  resolves and parses as the JAX one does, errors included.
- Meshes of CPU shards (`[torch.device("cpu")] * n`) meet the port's
  single-device training at the JAX tests' tolerances; a one-shard mesh
  gives `_run_als`'s factors exactly; each shard holds dpad / n rows.
- The port's `_train_on_mesh` meets the JAX `_train_on_mesh` on the 8
  virtual CPU devices from the same starting factors (the two packages'
  initial draws differ by design) within 2e-3.
- `hbm_footprint`'s contract; `cli train --mesh` records the mesh;
  `serve_mesh_from_conf` reads a recorded mesh; `prepare_deploy` hands
  it the instance's conf merged with the server's.
"""

import json

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jals
from predictionio_tpu.parallel import MeshSpec as JMeshSpec
from predictionio_tpu.parallel import make_mesh as jmake_mesh
from predictionio_tpu_torch.cli import ops as cli_ops
from predictionio_tpu_torch.core import workflow as pwf
from predictionio_tpu_torch.core.runtime import RuntimeContext, WorkflowParams
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import StorageRegistry
from predictionio_tpu_torch.models import recommendation as prec
from predictionio_tpu_torch.ops import als as pals
from predictionio_tpu_torch.ops import topk_sharded
from predictionio_tpu_torch.parallel import Mesh, MeshSpec, make_mesh

pytestmark = pytest.mark.torch

CPU = torch.device("cpu")


def cpu_mesh(n):
    return make_mesh(MeshSpec({"data": n}), [CPU] * n)


def synthetic(n_users=40, n_items=30, rank=3, density=0.5, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(n_users, rank)
    y = rng.randn(n_items, rank)
    mask = rng.rand(n_users, n_items) < density
    u, i = np.nonzero(mask)
    return (u.astype(np.int32), i.astype(np.int32),
            (x @ y.T)[u, i].astype(np.float32))


def skewed(seed=3):
    """Zipf-like item popularity over contiguous ids: the low ids own most
    ratings, so owner packing pads the other shards."""
    rng = np.random.default_rng(seed)
    n = 3000
    u = rng.integers(0, 60, n).astype(np.int32)
    pop = np.arange(1, 81, dtype=np.float64) ** -1.2
    i = rng.choice(80, n, p=pop / pop.sum()).astype(np.int32)
    r = rng.integers(1, 6, n).astype(np.float32)
    return u, i, r


class TestPackByOwner:
    @pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
    @pytest.mark.parametrize("data", ["uniform", "skewed"])
    def test_byte_equal_to_jax(self, n_dev, data):
        u, i, r = synthetic(density=0.4) if data == "uniform" else skewed()
        n_rows = int(i.max()) + 1
        block = -(-n_rows // n_dev)
        for rank in (None, 4):
            kw = {} if rank is None else {"rank": rank}
            jside = jals._pack_side(i, u, r, n_rows, **kw)
            pside = pals._pack_side(i, u, r, n_rows, **kw)
            want = jals._pack_by_owner(jside, block, n_dev)
            got = pals._pack_by_owner(pside, block, n_dev)
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    assert a.dtype == b.dtype and a.shape == b.shape
                    assert a.tobytes() == b.tobytes()

    def test_skew_pads_the_other_shards(self):
        u, i, r = skewed()
        side = pals._pack_side(i, u, r, 80)
        packed = pals._pack_by_owner(side, 20, 4)
        fill = sum(int((rows == 20).sum()) for rows, _, _ in packed)
        real = sum(int((rows < 20).sum()) for rows, _, _ in packed)
        assert real == len(np.unique(i)) and fill > real


SPECS = [{}, {"mesh": ""}, {"mesh": "data=8"}, {"mesh": "data=4"},
         {"mesh": "data=-1"}, {"mesh": "data=2,model=4"},
         {"mesh": "data=-1,model=2"}, {"mesh": "data=3"},
         {"mesh": "data=9"}, {"mesh": "data=-1,model=-1"},
         {"mesh": "data=4,model=4"}, {"mesh": " data = 2 "}]


class TestMeshSpec:
    @pytest.mark.parametrize("conf", SPECS, ids=lambda c: c.get("mesh", "-"))
    @pytest.mark.parametrize("n_devices", [1, 7, 8])
    def test_resolve_and_from_conf_equal_jax(self, conf, n_devices):
        pspec, jspec = MeshSpec.from_conf(conf), JMeshSpec.from_conf(conf)
        assert dict(pspec.axes) == dict(jspec.axes)

        def outcome(spec):
            try:
                return spec.resolve(n_devices)
            except ValueError as e:
                return ("error", str(e))
        assert outcome(pspec) == outcome(jspec)

    def test_make_mesh_prefix_repeats_and_raises(self):
        mesh = make_mesh(MeshSpec({"data": 4}), [CPU] * 7)
        assert isinstance(mesh, Mesh) and mesh.shape == {"data": 4}
        assert mesh.devices == (CPU,) * 4 and mesh.local == (0, 1, 2, 3)
        assert make_mesh(None, [CPU] * 7).shape == {"data": 7}
        with pytest.raises(ValueError, match="needs 4 devices, have 2"):
            make_mesh(MeshSpec({"data": 4}), [CPU] * 2)

    def test_context_mesh_from_runtime_conf(self, monkeypatch):
        monkeypatch.setenv("PIO_CPU_DEVICE_COUNT", "4")
        ctx = RuntimeContext(device="cpu", workflow_params=WorkflowParams(
            runtime_conf={"mesh": "data=2"}))
        assert ctx.mesh.shape == {"data": 2}
        assert ctx.mesh.devices == (CPU, CPU)
        assert RuntimeContext(device="cpu").mesh.shape == {"data": 4}
        given = cpu_mesh(3)
        assert ctx.with_mesh(given).mesh is given
        monkeypatch.delenv("PIO_CPU_DEVICE_COUNT")
        assert RuntimeContext(device="cpu").mesh.shape == {"data": 1}
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            RuntimeContext(device="cpu", workflow_params=WorkflowParams(
                runtime_conf={"mesh": "data=2"})).mesh

    def test_context_mesh_raises_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            RuntimeContext().mesh

    def test_als_refuses_other_axes(self):
        """Another axis replicates ALS (the data=2,model=2 case is in
        TestOtherAxes); ALS refuses a mesh of other axes alone, and one
        whose "model" axis spans processes."""
        u, i, v = synthetic()
        with pytest.raises(ValueError, match="has none"):
            pals.als_train((u, i, v), 40, 30, rank=3, iterations=1,
                           mesh=make_mesh(MeshSpec({"model": 2}), [CPU] * 2))
        spanning = Mesh(("model", "data"), (2, 2), (CPU,) * 4, 0, 2)
        with pytest.raises(NotImplementedError, match="'model' axis"):
            pals.als_train((u, i, v), 40, 30, rank=3, iterations=1,
                           mesh=spanning)


class TestShardedMatchesSingleDevice:
    def test_sharded_matches_single_device(self):
        u, i, v = synthetic(density=0.4)
        x0, y0 = pals.als_train((u, i, v), 40, 30, rank=4, iterations=4,
                                reg=0.05, seed=2, device="cpu")
        for n in (2, 3, 8):
            x1, y1 = pals.als_train((u, i, v), 40, 30, rank=4, iterations=4,
                                    reg=0.05, seed=2, mesh=cpu_mesh(n))
            np.testing.assert_allclose(x0, x1, rtol=1e-3, atol=1e-3)
            np.testing.assert_allclose(y0, y1, rtol=1e-3, atol=1e-3)

    def test_sharded_paired_matches_unsharded(self):
        u, i, v = synthetic(48, 32, 3, density=0.5, seed=10)
        kw = dict(rank=24, iterations=3, reg=0.05, seed=4, precision="f32",
                  cg_iters=64)
        x0, y0 = pals.als_train((u, i, v), 48, 32, device="cpu", **kw)
        tm = {}
        x1, y1 = pals.als_train((u, i, v), 48, 32, mesh=cpu_mesh(8),
                                timings=tm, **kw)
        np.testing.assert_allclose(x0, x1, rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(y0, y1, rtol=2e-3, atol=2e-3)
        assert {"pack_s", "owner_pack_s", "transfer_s", "solve_s",
                "fetch_s"} <= set(tm)
        assert 0 < tm["solver_residual"] < 1e-2

    def test_sharded_implicit_matches_single_device(self):
        u, i, v = synthetic(30, 24, 3, density=0.4, seed=5)
        v = np.abs(v) + 0.5
        kw = dict(rank=4, iterations=3, reg=0.05, implicit=True, alpha=2.0,
                  seed=3)
        xs, ys = pals.als_train((u, i, v), 30, 24, mesh=cpu_mesh(8), **kw)
        x1, y1 = pals.als_train((u, i, v), 30, 24, device="cpu", **kw)
        np.testing.assert_allclose(xs, x1, rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(ys, y1, rtol=2e-3, atol=2e-4)

    def test_split_slabs_match_on_mesh(self, monkeypatch):
        u, i, v = synthetic(32, 24, 3, density=0.5, seed=11)
        x0, y0 = pals.als_train((u, i, v), 32, 24, rank=4, iterations=2,
                                reg=0.05, seed=2, device="cpu")
        monkeypatch.setattr(pals, "_SLAB_NORMAL_BUDGET", 4 * 4 * 4 * 4)
        packed = pals.pack_ratings(u, i, v, 32, 24, rank=4)
        assert len(packed.user_side.rows) > len(
            pals._pack_side(u, i, v, 32).rows)
        x1, y1 = pals.als_train(None, rank=4, iterations=2, reg=0.05,
                                seed=2, packed=packed, mesh=cpu_mesh(4))
        np.testing.assert_allclose(x0, x1, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(y0, y1, rtol=1e-3, atol=1e-4)

    def test_skewed_ownership_and_unrated_rows(self):
        u, i, r = skewed()
        kw = dict(rank=24, iterations=3, reg=0.05, seed=1, precision="f32",
                  cg_iters=64)
        x0, y0 = pals.als_train((u, i, r), 64, 90, device="cpu", **kw)
        x1, y1 = pals.als_train((u, i, r), 64, 90, mesh=cpu_mesh(4), **kw)
        np.testing.assert_allclose(x0, x1, rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(y0, y1, rtol=2e-3, atol=2e-3)
        assert torch.all(y1[80:] == 0) and torch.all(x1[60:] == 0)

    @pytest.mark.parametrize("rank,implicit", [(4, False), (24, False),
                                               (24, True)])
    def test_one_shard_mesh_is_run_als_exactly(self, rank, implicit):
        u, i, v = synthetic(density=0.4)
        v = np.abs(v) + 0.5 if implicit else v
        kw = dict(rank=rank, iterations=3, reg=0.05, seed=2,
                  implicit=implicit)
        x0, y0 = pals.als_train((u, i, v), 40, 30, device="cpu", **kw)
        x1, y1 = pals.als_train((u, i, v), 40, 30, device="cpu",
                                mesh=cpu_mesh(1), **kw)
        assert torch.equal(x0, x1) and torch.equal(y0, y1)

    def test_factors_are_sharded_not_replicated(self):
        u, i, v = synthetic(32, 24, 3, density=0.4, seed=7)
        user_side = pals._pack_side(u, i, v, 32)
        item_side = pals._pack_side(i, u, v, 24)
        for n in (3, 8):
            x_b, y_b, res = pals._train_on_mesh(
                np.full((32, 4), 0.1, np.float32),
                np.full((24, 4), 0.1, np.float32), user_side, item_side,
                32, 24, cpu_mesh(n), reg=0.05, alpha=1.0, iterations=2,
                implicit=False, rank=4)
            for blocks, rows in ((x_b, 32), (y_b, 24)):
                dpad = -(-rows // n) * n
                assert len(blocks) == n
                assert {b.shape for b in blocks} == {(dpad // n, 4)}
            assert res.dim() == 0


class TestAgainstJaxTrainOnMesh:
    @pytest.mark.parametrize("rank,precision,cg_iters", [
        (4, "f32", 8), (24, "f32", 64)])
    def test_train_on_mesh_matches_jax(self, rank, precision, cg_iters):
        u, i, v = synthetic(48, 32, 3, density=0.5, seed=10)
        rng = np.random.default_rng(0)
        x0 = (np.abs(rng.standard_normal((48, rank))) / np.sqrt(rank)
              ).astype(np.float32)
        y0 = (np.abs(rng.standard_normal((32, rank))) / np.sqrt(rank)
              ).astype(np.float32)
        kw = dict(reg=0.05, alpha=1.0, iterations=3, implicit=False,
                  rank=rank, cg_iters=cg_iters)
        jmesh = jmake_mesh()
        jx, jy, _ = jals._train_on_mesh(
            x0, y0, jals._pack_side(u, i, v, 48, rank),
            jals._pack_side(i, u, v, 32, rank), 48, 32, jmesh, **kw)
        px, py, _ = pals._train_on_mesh(
            x0, y0, pals._pack_side(u, i, v, 48, rank),
            pals._pack_side(i, u, v, 32, rank), 48, 32,
            cpu_mesh(int(jmesh.shape["data"])), **kw)
        np.testing.assert_allclose(torch.cat(px)[:48], np.asarray(jx)[:48],
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(torch.cat(py)[:32], np.asarray(jy)[:32],
                                   rtol=2e-3, atol=2e-3)


class TestHbmFootprint:
    def test_contract(self):
        fp = pals.hbm_footprint(1000, 500, 20_000, rank=32, n_devices=4)
        assert set(fp) == {"persistent", "transient", "peak"}
        assert fp["peak"] == fp["persistent"] + fp["transient"]
        assert all(v > 0 for v in fp.values())
        more = pals.hbm_footprint(1000, 500, 20_000, rank=32, n_devices=8)
        assert more["persistent"] < fp["persistent"]
        skew = pals.hbm_footprint(1000, 500, 20_000, rank=32, n_devices=4,
                                  owner_skew=4.0)
        assert skew["peak"] > fp["peak"]
        exact = pals.hbm_footprint(1000, 500, 20_000, rank=8, n_devices=4)
        assert exact["peak"] < fp["peak"]

    @pytest.mark.parametrize("n_devices", [4, 8])
    def test_ml25m_rank64_fits_half_an_80gb_card(self, n_devices):
        fp = pals.hbm_footprint(162_541, 59_047, 25_000_000, rank=64,
                                n_devices=n_devices)
        assert fp["peak"] < 80e9 * 0.5
        assert fp["persistent"] < 1 << 30

    @pytest.mark.parametrize("data,skew", [("uniform", 2.0),
                                           ("skewed", 4.0)])
    def test_bounds_a_small_run(self, data, skew):
        """Every persistent buffer of a small sharded run fits the bound's
        persistent term (the device slabs and `_prepare_side`'s, 5 words
        per padded entry): uniform ids at the default skew, a Zipf
        catalog over contiguous ids at the worst case, n_devices."""
        u, i, r = synthetic(60, 80, density=0.4) if data == "uniform" \
            else skewed()
        n, rank = 4, 24
        fp = pals.hbm_footprint(60, 80, len(u), rank, n, owner_skew=skew)
        mesh = cpu_mesh(n)
        owned = [pals._owner_slabs(pals._pack_side(a, b, r, m, rank),
                                   -(-m // n), mesh)
                 for a, b, m in ((u, i, 60), (i, u, 80))]
        for s in range(n):
            words = sum(idx.size * 5 for side in owned
                        for _, idx, _ in side[s])
            assert words * 4 + (60 + 80) * rank * 4 / n <= fp["persistent"]

    def test_shared_card_bound_splits_persistent_and_transient(self):
        """Shards sharing one card: every shard's persistent buffers
        (the device slabs, `_prepare_side`'s, the factor rows) add up
        under shards x persistent, and the bound keeps one transient:
        below shards x peak, and the peak itself for one shard."""
        u, i, r = skewed()
        n, rank = 4, 24
        fp = pals.hbm_footprint(60, 80, len(u), rank, n, owner_skew=4.0)
        bound = pals.shared_card_bound(fp, n)
        assert bound == n * fp["persistent"] + fp["transient"]
        assert fp["peak"] <= bound < n * fp["peak"]
        assert pals.shared_card_bound(fp, 1) == fp["peak"]
        mesh = cpu_mesh(n)
        owned = [pals._owner_slabs(pals._pack_side(a, b, r, m, rank),
                                   -(-m // n), mesh)
                 for a, b, m in ((u, i, 60), (i, u, 80))]
        words = sum(idx.size * 5 for side in owned for s in range(n)
                    for _, idx, _ in side[s])
        assert words * 4 + (60 + 80) * rank * 4 <= n * fp["persistent"]


class TestOtherAxes:
    """A mesh with "model" or "sp" axes trains ALS over its "data" axis:
    the factors equal a "data"-only mesh's bit for bit (the exact path
    and the bf16 CG path, explicit and implicit)."""

    @pytest.mark.parametrize("rank,implicit", [(4, False), (24, False),
                                               (24, True)])
    @pytest.mark.parametrize("other", [{"model": 2}, {"sp": 2}],
                             ids=["model2", "sp2"])
    def test_factors_equal_the_data_only_mesh(self, rank, implicit, other):
        u, i, v = synthetic(density=0.4)
        v = np.abs(v) if implicit else v
        kw = dict(rank=rank, iterations=3, reg=0.05, seed=2,
                  implicit=implicit)
        x2, y2 = pals.als_train((u, i, v), 40, 30, mesh=cpu_mesh(2), **kw)
        spec = {"data": 2, **other}
        xg, yg = pals.als_train((u, i, v), 40, 30, mesh=make_mesh(
            MeshSpec(spec), [CPU] * 4), **kw)
        assert torch.equal(x2, xg) and torch.equal(y2, yg)

    def test_data_mesh_of_a_grid(self):
        grid = make_mesh(MeshSpec({"data": 2, "model": 2}), [CPU] * 4)
        dm = pals._data_mesh(grid)
        assert dm.shape == {"data": 2} and dm.size == 2
        assert pals._data_shards(grid) == 2


VARIANT = {"id": "default", "engineFactory": "recommendation",
           "datasource": {"params": {"app_name": "shop"}},
           "algorithms": [{"name": "als", "params": {
               "rank": 4, "num_iterations": 2, "lambda_": 0.1, "seed": 5}}]}


def _registry(n_events=300):
    r = StorageRegistry({"PIO_STORAGE_SOURCES_M_TYPE": "MEM"})
    app = cli_ops.app_new(r, "shop")["id"]
    rng = np.random.default_rng(0)
    r.get_events().insert_batch([
        Event("rate", "user", f"u{rng.integers(0, 20)}", "item",
              f"i{rng.integers(0, 25)}",
              DataMap({"rating": float(rng.integers(1, 6))}))
        for _ in range(n_events)], app)
    return r


class TestTrainCommandAndDeploy:
    def test_cli_train_mesh_records_the_mesh(self, tmp_path, monkeypatch):
        monkeypatch.setenv("PIO_CPU_DEVICE_COUNT", "2")
        registry = _registry()
        (tmp_path / "engine.json").write_text(json.dumps(VARIANT))
        report = cli_ops.train(registry,
                               engine_json=str(tmp_path / "engine.json"),
                               device="cpu", mesh="data=2")
        assert report["status"] == "COMPLETED"
        assert report["distributed"] is False and report["persisted"] is True
        assert "owner_pack_s" in report["phaseTimings"]
        inst = registry.get_meta_data_engine_instances().get(
            report["engineInstanceId"])
        assert inst.runtime_conf["mesh"] == "data=2"
        # the same factors as a one-device train of the variant
        single = cli_ops.train(registry,
                               engine_json=str(tmp_path / "engine.json"),
                               device="cpu", mesh="data=1")
        engine = prec.RecommendationEngine.apply()
        ctx = RuntimeContext(registry=registry, device="cpu")
        models = [pwf.CoreWorkflow.prepare_deploy(
            engine, registry.get_meta_data_engine_instances().get(
                rep["engineInstanceId"]), ctx)[1][0]
                  for rep in (report, single)]
        np.testing.assert_allclose(models[0].user_factors,
                                   models[1].user_factors,
                                   rtol=1e-3, atol=1e-3)

    def test_run_train_without_persist_writes_nothing(self):
        registry = _registry()
        engine = prec.RecommendationEngine.apply()
        ctx = RuntimeContext(registry=registry, device="cpu")
        row = pwf.CoreWorkflow.run_train(
            engine, engine.engine_params_from_variant(VARIANT), ctx,
            engine_variant="default", persist=False)
        assert row.status == "COMPLETED" and row.id == ""
        assert registry.get_meta_data_engine_instances().get_all() == []
        assert "solve_s" in ctx.phase_timings

    def test_serve_mesh_from_conf(self, monkeypatch):
        monkeypatch.delenv("PIO_SERVE_SHARD", raising=False)
        monkeypatch.delenv("PIO_SERVE_SHARDS", raising=False)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        sm = topk_sharded.serve_mesh_from_conf({"mesh": "data=4"})
        assert sm.forced and sm.n_shards == 4
        assert sm.devices == tuple(torch.device("cuda", c) for c in range(4))
        assert not topk_sharded.serve_mesh_from_conf({}).forced
        assert not topk_sharded.serve_mesh_from_conf(
            {"mesh": "items=3@fleet"}).forced
        assert topk_sharded.serve_mesh_from_conf(
            {"mesh": "items=3@fleet:1"}) == topk_sharded.ShardSlice(3, 1)
        monkeypatch.setenv("PIO_SERVE_SHARDS", "2")
        assert topk_sharded.serve_mesh_from_conf(
            {"mesh": "data=4"}).n_shards == 2
        monkeypatch.setenv("PIO_SERVE_SHARD", "off")
        assert topk_sharded.serve_mesh_from_conf({"mesh": "data=4"}) is None
        monkeypatch.delenv("PIO_SERVE_SHARD")
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        assert topk_sharded.serve_mesh_from_conf({"mesh": "data=4"}) is None

    def test_prepare_deploy_passes_the_merged_conf(self, monkeypatch):
        monkeypatch.setenv("PIO_CPU_DEVICE_COUNT", "2")
        registry = _registry()
        engine = prec.RecommendationEngine.apply()
        ctx = RuntimeContext(registry=registry, device="cpu",
                             workflow_params=WorkflowParams(
                                 runtime_conf={"mesh": "data=2"}))
        row = pwf.CoreWorkflow.run_train(
            engine, engine.engine_params_from_variant(VARIANT), ctx,
            engine_variant="default")
        seen = []

        def recording(conf=None):
            seen.append(dict(conf))
            return None
        monkeypatch.setattr(topk_sharded, "serve_mesh_from_conf", recording)
        server_ctx = RuntimeContext(registry=registry, device="cpu",
                                    workflow_params=WorkflowParams(
                                        runtime_conf={"tier": "x"}))
        algos, _, _ = pwf.CoreWorkflow.prepare_deploy(
            engine, row, server_ctx, warm_batch_max=2)
        assert seen and seen[0]["mesh"] == "data=2" and seen[0]["tier"] == "x"
        assert algos[0]._serve_plan is not None
        # an explicit mesh wins: the conf is not read
        seen.clear()
        pwf.CoreWorkflow.prepare_deploy(
            engine, row, server_ctx, warm_batch_max=2,
            mesh=topk_sharded.ServeMesh((CPU, CPU), forced=True))
        assert seen == []
