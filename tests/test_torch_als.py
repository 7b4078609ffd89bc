"""The port's ALS training (`predictionio_tpu_torch.ops.als`) against the
JAX package's (`predictionio_tpu.ops.als`) and its float64 numpy oracle
(`predictionio_tpu.ops.oracle`), on the CPU.

- Host packing and the device slabs are `np.array_equal` to the JAX
  package's.
- `_solve_bucket` (the exact path) within rtol 1e-4 of the JAX one and
  2e-3 of the oracle's half-step.
- `_run_als` from the JAX `init_factors`: within 1e-3 of the JAX loop on
  the exact path (rank 10) and where CG has converged (rank 24, f32, 64
  steps); at the default (bf16, 8 CG steps) the port solves each row as
  its own system where the JAX package pairs rows, so the iterates
  differ and the check is RMSE within 1e-2 of the oracle's and of the
  JAX package's; implicit feedback by reconstructed scores at the JAX
  tests' 0.05 (f32) and 0.1 (bf16).
"""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from predictionio_tpu.ops import als as jals
from predictionio_tpu.ops import oracle
from predictionio_tpu_torch import device as pdev
from predictionio_tpu_torch.ops import als as pals

pytestmark = pytest.mark.torch


def synthetic(n_users=40, n_items=30, rank=3, density=0.5, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(n_users, rank)
    y = rng.randn(n_items, rank)
    mask = rng.rand(n_users, n_items) < density
    u, i = np.nonzero(mask)
    return (u.astype(np.int32), i.astype(np.int32),
            (x @ y.T)[u, i].astype(np.float32))


def heavy_tail(seed=7):
    """One power user with 600 ratings, the rest with ~5: several degree
    buckets, odd slabs (so `_FILL_ROW` rows), and unrated users."""
    rng = np.random.RandomState(seed)
    rows = [0] * 600 + [u for u in range(1, 29) for _ in range(5)]
    cols = [i % 50 for i in range(600)] + list(rng.randint(0, 50, 28 * 5))
    vals = rng.uniform(1, 5, len(rows))
    return (np.array(rows, np.int32), np.array(cols, np.int32),
            np.array(vals, np.float32))


def _side_equal(js, ps_):
    assert js.n_rows == ps_.n_rows and js.caps == ps_.caps
    for field in ("rows", "counts", "idx", "val"):
        a, b = getattr(js, field), getattr(ps_, field)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y), field
    for j in range(len(js.rows)):
        for x, y in zip(js.padded(j), ps_.padded(j)):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("rank", [None, 4, 64])
@pytest.mark.parametrize("data", ["synthetic", "heavy_tail"])
def test_pack_side_is_bit_identical(data, rank):
    u, i, v = synthetic(60, 40, 3, 0.3) if data == "synthetic" \
        else heavy_tail()
    _side_equal(jals._pack_side(u, i, v, 60, rank),
                pals._pack_side(u, i, v, 60, rank))
    _side_equal(jals._pack_side(i, u, v, 60, rank),
                pals._pack_side(i, u, v, 60, rank))


def test_pack_ratings_with_split_slabs_is_bit_identical(monkeypatch):
    u, i, v = synthetic(50, 40, 3, 0.5, seed=9)
    for mod in (jals, pals):
        monkeypatch.setattr(mod, "_SLAB_NORMAL_BUDGET", 4 * 4 * 4 * 8)
    jp = jals.pack_ratings(u, i, v, 50, 40, rank=4)
    pp = pals.pack_ratings(u, i, v, 50, 40, rank=4)
    assert len(pp.user_side.rows) > len(pals._pack_side(u, i, v, 50).rows)
    _side_equal(jp.user_side, pp.user_side)
    _side_equal(jp.item_side, pp.item_side)
    assert (pp.n_users, pp.n_items, pp.rank) == (50, 40, 4)
    assert np.array_equal(jals._cap_ladder(1000), pals._cap_ladder(1000))


@pytest.mark.parametrize("val_dtype", ["f32", "bf16"])
def test_device_slabs_are_the_jax_padded_arrays(val_dtype):
    u, i, v = heavy_tail()
    v = np.round(v * 2) / 2                         # bf16-exact half stars
    jside = jals._pack_side(u, i, v, 30, 64)
    pside = pals._pack_side(u, i, v, 30, 64)
    jdt = jnp.bfloat16 if val_dtype == "bf16" else np.float32
    tdt = torch.bfloat16 if val_dtype == "bf16" else torch.float32
    jslabs = jals.device_slabs(jside, 50, jdt)
    pslabs = pals.device_slabs(pside, tdt, "cpu")
    assert len(jslabs) == len(pslabs) == len(pside.rows)
    for (jr, ji, jv), (pr, pi, pv) in zip(jslabs, pslabs):
        assert pr.dtype == pi.dtype == torch.int32 and pv.dtype == tdt
        assert np.array_equal(np.asarray(jr), pr.numpy())
        assert np.array_equal(np.asarray(ji).astype(np.int32), pi.numpy())
        assert np.array_equal(np.asarray(jv).astype(np.float32),
                              pv.float().numpy())
    assert pals.device_slabs(pals._pack_side(u[:0], i[:0], v[:0], 30),
                             device="cpu") == []


def _bucket_halfstep(mod_solve, to_dev, y, side, reg, alpha, implicit):
    """One half-step over every slab of `side` through a `_solve_bucket`."""
    rank = y.shape[1]
    x = np.zeros((side.n_rows, rank), np.float32)
    yty = y.T @ y if implicit else np.zeros((rank, rank), np.float32)
    for j, rows in enumerate(side.rows):
        idx, val = side.padded(j)
        sol = np.asarray(mod_solve(to_dev(y), to_dev(idx), to_dev(val), reg,
                                   alpha, to_dev(yty), implicit))
        real = rows != pals._FILL_ROW
        x[rows[real]] = sol[real]
    return x


@pytest.mark.parametrize("rank", [3, 16, 24])
@pytest.mark.parametrize("implicit", [False, True])
def test_solve_bucket_matches_jax_and_oracle(rank, implicit):
    u, i, v = synthetic(40, 30, 3, 0.5)
    if implicit:
        v = np.abs(v)
    y = np.random.RandomState(0).randn(30, rank).astype(np.float32)
    side = pals._pack_side(u, i, v, 40)
    alpha = 2.0 if implicit else 1.0

    def jsolve(f, idx, val, reg, a, yty, imp):
        return jals._solve_bucket(f, idx, val, jnp.float32(reg),
                                  jnp.float32(a), yty, implicit=imp)

    def psolve(f, idx, val, reg, a, yty, imp):
        return pals._solve_bucket(f, idx, val, reg, a, yty,
                                  implicit=imp).numpy()

    got = _bucket_halfstep(psolve, torch.from_numpy, y, side, 0.1, alpha,
                           implicit)
    want = _bucket_halfstep(jsolve, jnp.asarray, y, side, 0.1, alpha,
                            implicit)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    ref = (oracle.user_step_implicit(y, u, i, v, 40, 0.1, alpha)
           if implicit else oracle.user_step(y, u, i, v, 40, 0.1))
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)


def _both_loops(u, i, v, n_users, n_items, rank, *, iters, reg, precision,
                cg_iters=pals._CG_ITERS, implicit=False, alpha=1.0, seed=2):
    """The JAX and the port `_run_als` from the same JAX init and the
    same packing; returns (jax x, y, res), (port x, y, res), init."""
    x0, y0 = jals.init_factors(n_users, n_items, rank, seed)
    jp = jals.pack_ratings(u, i, v, n_users, n_items, rank)
    pp = pals.pack_ratings(u, i, v, n_users, n_items, rank)
    bf16 = precision == "bf16" and rank > 16 and not implicit
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (np.float32, torch.float32))
    jx, jy, jr = jals._run_als(
        jnp.asarray(x0), jnp.asarray(y0),
        jals.device_slabs(jp.user_side, n_items, jdt),
        jals.device_slabs(jp.item_side, n_users, jdt), jnp.float32(reg),
        jnp.float32(alpha), jnp.int32(iters), implicit=implicit, rank=rank,
        cg_iters=cg_iters,
        cast={"bf16": jnp.bfloat16, "f32": None}[precision])
    px, py, pr = pals._run_als(
        torch.from_numpy(x0), torch.from_numpy(y0),
        pals.device_slabs(pp.user_side, tdt, "cpu"),
        pals.device_slabs(pp.item_side, tdt, "cpu"), reg, alpha, iters,
        implicit=implicit, rank=rank, cg_iters=cg_iters,
        cast={"bf16": torch.bfloat16, "f32": None}[precision])
    return ((np.asarray(jx), np.asarray(jy), float(jr)),
            (px.numpy(), py.numpy(), float(pr)), (x0, y0))


def test_run_als_exact_path_matches_jax():
    u, i, v = synthetic(60, 40, 4, 0.4, seed=5)
    (jx, jy, jr), (px, py, pr), _ = _both_loops(
        u, i, v, 60, 40, 10, iters=6, reg=0.05, precision="bf16")
    np.testing.assert_allclose(px, jx, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(py, jy, rtol=1e-3, atol=1e-3)
    assert pr == jr == 0.0


def test_run_als_converged_cg_matches_jax():
    u, i, v = synthetic(60, 40, 4, 0.4, seed=5)
    (jx, jy, _), (px, py, pr), _ = _both_loops(
        u, i, v, 60, 40, 24, iters=6, reg=0.05, precision="f32",
        cg_iters=64)
    np.testing.assert_allclose(px, jx, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(py, jy, rtol=1e-3, atol=1e-3)
    assert 0.0 < pr < 1e-4


@pytest.mark.parametrize("seed", [6, 11])
def test_run_als_bf16_default_rmse_matches_oracle_and_jax(seed):
    u, i, v = synthetic(60, 40, 4, 0.4, seed=seed)
    (jx, jy, _), (px, py, pr), (x0, y0) = _both_loops(
        u, i, v, 60, 40, 24, iters=6, reg=0.05, precision="bf16")
    xo, yo = oracle.als_train(u, i, v, 60, 40, rank=24, iterations=6,
                              reg=0.05, x0=x0, y0=y0)
    ours = pals.rmse(torch.from_numpy(px), torch.from_numpy(py), u, i, v)
    assert abs(ours - oracle.rmse(xo, yo, u, i, v)) < 1e-2
    assert abs(ours - jals.rmse(jx, jy, u, i, v)) < 1e-2
    assert 0.0 < pr < 1e-2


@pytest.mark.parametrize("precision,tol", [("f32", 0.05), ("bf16", 0.1)])
def test_run_als_implicit_scores_match_oracle_and_jax(precision, tol):
    u, i, v = synthetic(40, 30, 3, 0.4, seed=7)
    v = np.abs(v)
    (jx, jy, _), (px, py, _), (x0, y0) = _both_loops(
        u, i, v, 40, 30, 20, iters=5, reg=0.05, precision=precision,
        implicit=True, alpha=2.0, seed=3)
    xo, yo = oracle.als_train_implicit(u, i, v, 40, 30, rank=20,
                                       iterations=5, reg=0.05, alpha=2.0,
                                       x0=x0, y0=y0)
    np.testing.assert_allclose(px @ py.T, xo @ yo.T, rtol=tol, atol=tol)
    np.testing.assert_allclose(px @ py.T, jx @ jy.T, rtol=tol, atol=tol)


@pytest.mark.parametrize("implicit", [False, True])
def test_cg_batches_split_like_one_batch(monkeypatch, implicit):
    """A side's slabs share one CG up to `_CG_BATCH_BUDGET`; with a
    budget of a few rows every slab is its own batch (the JAX package's
    per-slab CG), and the factors are the same: each row's CG is its
    own."""
    u, i, v = heavy_tail()
    v = np.abs(v)
    slabs = pals.device_slabs(pals._pack_side(u, i, v, 32, 24),
                              device="cpu")
    assert len(slabs) >= 2
    x0, y0 = torch.rand(32, 24), torch.rand(50, 24)
    kw = dict(implicit=implicit, rank=24, cg_iters=8)
    x1, y1, r1 = pals._run_als(x0, y0, slabs, [], 0.1, 2.0, 2, **kw)
    monkeypatch.setattr(pals, "_CG_BATCH_BUDGET", 24 * 24 * 4 * 3)
    batches = pals._prepare_side(slabs, 32, 50, 0.1, 2.0, implicit=implicit,
                                 cast=torch.float32, rank=24)
    assert len(batches) == len(slabs)
    x2, y2, r2 = pals._run_als(x0, y0, slabs, [], 0.1, 2.0, 2, **kw)
    np.testing.assert_allclose(x2.numpy(), x1.numpy(), rtol=1e-5, atol=1e-6)
    assert torch.equal(y1, y0) and torch.equal(y2, y0)
    assert abs(float(r1) - float(r2)) < 1e-6


@pytest.mark.parametrize("implicit", [False, True])
def test_half_step_matches_the_oracle(implicit):
    """`half_step` (the unit the card's parity phase drives) at rank 24
    in f32 with converged CG, explicit and implicit."""
    u, i, v = synthetic(40, 30, 3, 0.5, seed=4)
    v = np.abs(v) if implicit else v
    rng = np.random.default_rng(1)
    y = (np.abs(rng.standard_normal((30, 24))) / 5).astype(np.float32)
    x0 = (np.abs(rng.standard_normal((40, 24))) / 5).astype(np.float32)
    slabs = pals.device_slabs(pals._pack_side(u, i, v, 40, 24),
                              device="cpu")
    got, res = pals.half_step(torch.from_numpy(x0), torch.from_numpy(y),
                              slabs, 0.1, 2.0, implicit=implicit,
                              cg_iters=96)
    ref = (oracle.user_step_implicit(y, u, i, v, 40, 0.1, 2.0) if implicit
           else oracle.user_step(y, u, i, v, 40, 0.1))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-3, atol=2e-3)
    assert res < 1e-4


def test_init_is_row_keyed():
    """Row r depends on (seed, side, r) only: the same rows at any
    height, other rows for another seed or side, abs(normal)/sqrt(rank)
    with the spread of a normal."""
    x1, y1 = pals.init_factors(30, 20, 8, seed=4)
    x2, y2 = pals.init_factors(500, 7, 8, seed=4)
    assert np.array_equal(x1, x2[:30]) and np.array_equal(y1[:7], y2)
    x3, _ = pals.init_factors(30, 20, 8, seed=5)
    assert not np.array_equal(x1, x3) and not np.array_equal(x1[:20], y1)
    big, _ = pals.init_factors(20000, 1, 8, seed=0)
    assert big.dtype == np.float32 and (big >= 0).all()
    z = big * np.sqrt(8)
    assert abs(z.mean() - np.sqrt(2 / np.pi)) < 0.01
    assert abs((z ** 2).mean() - 1.0) < 0.01
    x4, _ = pals.init_factors(5, 2, 8, 4, user_present=np.array(
        [True, False, True, False, True]))
    assert np.array_equal(x4[[1, 3]], np.zeros((2, 8), np.float32))
    assert np.array_equal(x4[[0, 2, 4]], x1[[0, 2, 4]])


def test_implicit_unrated_phantom_items_do_not_bias():
    """tests/test_als.py's phantom-item invariance, on the port: 500
    never-rated items change nothing and stay zero."""
    rows = [u for u in range(10) for _ in range(3)]
    cols = [(u % 2) * 3 + j for u in range(10) for j in range(3)]
    u_ix, i_ix = np.array(rows, np.int32), np.array(cols, np.int32)
    val = np.ones(len(rows), np.float32)
    kw = dict(rank=4, iterations=5, reg=0.05, implicit=True, alpha=10.0,
              seed=4, device="cpu")
    x0, y0 = pals.als_train((u_ix, i_ix, val), 10, 6, **kw)
    x1, y1 = pals.als_train((u_ix, i_ix, val), 10, 506, **kw)
    np.testing.assert_allclose((x0 @ y0[:6].T).numpy(),
                               (x1 @ y1[:6].T).numpy(), rtol=1e-3, atol=1e-3)
    assert bool((y1[6:] == 0).all())


@pytest.mark.parametrize("rank", [3, 24])
def test_unrated_rows_stay_zero_and_fill_rows_are_never_written(rank):
    u, i, v = heavy_tail()
    side = pals._pack_side(u, i, v, 32, rank)
    assert any(pals._FILL_ROW in rows for rows in side.rows)
    x, y = pals.als_train((u, i, v), 32, 50, rank=rank, iterations=3,
                          reg=0.1, device="cpu")
    assert x.shape == (32, rank) and y.shape == (50, rank)
    assert bool((x[29:] == 0).all()) and bool((x[:29] != 0).any(dim=1).all())
    # a write at _FILL_ROW would raise (index out of range) on the CPU
    # and be a device-side assert on CUDA: the loop drops those rows
    xs = torch.zeros(32, rank)
    pals._run_als(xs, torch.ones(50, rank),
                  pals.device_slabs(side, device="cpu"), [], 0.1, 1.0, 1,
                  implicit=False, rank=rank)
    assert bool((xs == 0).all())    # the inputs are not modified


def test_bf16_exact():
    assert pals._bf16_exact([np.array([0.5, 3.0, 4.5], np.float32)])
    assert not pals._bf16_exact([np.array([4.7], np.float32)])
    assert pals._bf16_exact([]) and pals._bf16_exact([np.zeros(0)])
    for a in ([np.array([1.0, 4.7])], [np.array([2.5]), np.array([np.nan])]):
        assert pals._bf16_exact(a) == jals._bf16_exact(a)


def test_value_upload_is_f32_when_bf16_would_round(monkeypatch):
    """4.7-valued ratings cross in f32 on the bf16 path; half stars in
    bf16; implicit feedback and the exact path always in f32."""
    seen = []
    real = pals.device_slabs

    def spy(side, val_dtype=torch.float32, device=None):
        seen.append(val_dtype)
        return real(side, val_dtype, device)

    monkeypatch.setattr(pals, "device_slabs", spy)
    u, i, v = synthetic(30, 20, 3, 0.5)
    half = np.round(v * 2) / 2
    for vals, rank, implicit, want in ((half, 24, False, torch.bfloat16),
                                       (half + 0.2, 24, False, torch.float32),
                                       (np.abs(half), 24, True,
                                        torch.float32),
                                       (half, 8, False, torch.float32)):
        seen.clear()
        pals.als_train((u, i, vals.astype(np.float32)), 30, 20, rank=rank,
                       iterations=1, implicit=implicit, device="cpu")
        assert seen == [want, want]


def test_nonconvergence_warns(caplog):
    u, i, v = synthetic(60, 40, 4, 0.4, seed=9)
    tm = {}
    with caplog.at_level(logging.WARNING, logger="predictionio_tpu_torch.ops.als"):
        pals.als_train((u, i, v), 60, 40, rank=24, iterations=2,
                       reg=1e-12, cg_iters=1, precision="f32", timings=tm,
                       device="cpu")
    assert tm["solver_residual"] > 1e-2
    assert any("did not converge" in r.getMessage() for r in caplog.records)
    caplog.clear()
    pals._check_residual(1e-3, None)
    assert not caplog.records


def test_timings_and_residual_are_recorded():
    u, i, v = synthetic(20, 15, 2, 0.5, seed=3)
    tm = {"solver_residual": 0.5}
    pals.als_train((u, i, v), 20, 15, rank=20, iterations=2, reg=0.1,
                   timings=tm, device="cpu")
    assert set(tm) == {"pack_s", "transfer_s", "solve_s", "fetch_s",
                       "solver_residual"}
    assert tm["solver_residual"] == 0.5   # the worst of the run's solves
    tm = {}
    pals.als_train((u, i, v), 20, 15, rank=20, iterations=2, reg=0.1,
                   timings=tm, device="cpu", precision="f32")
    assert 0.0 < tm["solver_residual"] < 1e-2


def test_packed_input_and_rank_check():
    u, i, v = synthetic(20, 15, 2, 0.5, seed=3)
    packed = pals.pack_ratings(u, i, v, 20, 15, rank=4)
    x, y = pals.als_train(None, rank=4, iterations=2, reg=0.05, seed=1,
                          packed=packed, device="cpu")
    x2, y2 = pals.als_train((u, i, v), 20, 15, rank=4, iterations=2,
                            reg=0.05, seed=1, device="cpu")
    assert torch.equal(x, x2) and torch.equal(y, y2)
    with pytest.raises(ValueError, match="rank 4, not 8"):
        pals.als_train(None, rank=8, packed=packed, device="cpu")
    with pytest.raises(ValueError, match="n_users"):
        pals.als_train((u, i, v), rank=4, device="cpu")


def test_iteration_flops_counts_the_ports_work():
    """Full R x R Grams over the padded slots, no paired cross blocks:
    below the JAX count at rank > 16, equal in the Gram term below."""
    u, i, v = synthetic(20, 15, 2, 0.5, seed=3)
    p32 = pals.pack_ratings(u, i, v, 20, 15, rank=32)
    pad = pals.padded_entries(p32)
    assert pad == sum(len(r) * k for s in (p32.user_side, p32.item_side)
                      for r, k in zip(s.rows, s.caps))
    assert pad >= 2 * len(u)
    rows = sum(len(r) for s in (p32.user_side, p32.item_side)
               for r in s.rows)
    want = (2 * pad * 32 * 32 + 2 * pad * 32
            + rows * (8 * (2 * 32 * 32 + 12 * 32) + 4 * 32 * 32))
    assert pals.iteration_flops(p32) == want
    assert pals.iteration_flops(p32) < jals.iteration_flops(
        jals.pack_ratings(u, i, v, 20, 15, rank=32))
    p8 = pals.pack_ratings(u, i, v, 20, 15, rank=8)
    assert pals.iteration_flops(p8) == jals.iteration_flops(
        jals.pack_ratings(u, i, v, 20, 15, rank=8))


def test_rmse_matches_jax():
    u, i, v = synthetic(20, 15, 2, 0.5, seed=3)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((20, 4)).astype(np.float32)
    y = rng.standard_normal((15, 4)).astype(np.float32)
    assert abs(pals.rmse(torch.from_numpy(x), y, u, i, v)
               - jals.rmse(x, y, u, i, v)) < 1e-6


def test_als_train_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    u, i, v = synthetic(20, 15, 2, 0.5, seed=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pals.als_train((u, i, v), 20, 15, rank=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pals.device_slabs(pals._pack_side(u, i, v, 20))
    assert pdev.resolve_device("cpu").type == "cpu"

