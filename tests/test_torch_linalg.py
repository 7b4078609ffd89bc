"""The port's batched solvers (`predictionio_tpu_torch.ops.linalg`)
against the JAX package's (`predictionio_tpu.ops.linalg`) and float64
`np.linalg.solve`, on the CPU: `spd_solve` within rtol 1e-4 of the JAX
blocked Cholesky and 2e-3 of numpy; `pcg_solve` within 1e-4 of the JAX
CG from the same `x0` and trip count, with the same `return_info`
residuals and early-exit count."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from predictionio_tpu.ops import linalg as jlin
from predictionio_tpu_torch.ops import linalg as plin

pytestmark = pytest.mark.torch


def spd_batch(B, R, reg=0.5, seed=0, n_samples=None):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((B, n_samples or 2 * R, R)).astype(np.float32)
    a = np.einsum("bkr,bks->brs", g, g) + reg * np.eye(R, dtype=np.float32)
    b = rng.standard_normal((B, R)).astype(np.float32)
    return a, b


def ref_solve(a, b):
    return np.linalg.solve(a.astype(np.float64),
                           b.astype(np.float64)[..., None])[..., 0]


def port_spd(a, b):
    return plin.spd_solve(torch.from_numpy(a), torch.from_numpy(b)).numpy()


@pytest.mark.parametrize("R", [3, 10, 16, 17, 64])
def test_spd_solve_matches_jax_and_numpy(R):
    a, b = spd_batch(6, R, seed=R)
    got = port_spd(a, b)
    want = np.asarray(jlin.spd_solve(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, ref_solve(a, b), rtol=2e-3, atol=2e-3)


def test_spd_solve_reads_lower_triangle_only():
    a, b = spd_batch(3, 16)
    dirty = a + np.triu(np.ones_like(a[0]), k=1) * 7.0
    np.testing.assert_array_equal(port_spd(dirty, b), port_spd(a, b))


def test_spd_solve_identity_padding_rows_solve_to_zero():
    a, b = spd_batch(4, 10)
    a[1:3] = np.eye(10, dtype=np.float32)
    b[1:3] = 0.0
    got = port_spd(a, b)
    assert np.array_equal(got[1:3], np.zeros((2, 10), np.float32))
    np.testing.assert_allclose(got[[0, 3]], ref_solve(a, b)[[0, 3]],
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("R,iters,warm", [(4, 3, False), (10, 7, True),
                                          (24, 12, True), (64, 40, False),
                                          (64, 128, True)])
def test_pcg_solve_matches_jax(R, iters, warm):
    """The same systems, `x0` and trip count through both CGs: the
    iterates agree (the scalars are per batch element in both), and
    so do the true-residual norms down to fp32 rounding (1e-4: past
    convergence both sit at rounding noise)."""
    a, b = spd_batch(8, R, reg=1.0, seed=R + iters)
    x0 = (np.random.default_rng(R).standard_normal((8, R)).astype(np.float32)
          if warm else None)
    got, rel, k = plin.pcg_solve(
        torch.from_numpy(a), torch.from_numpy(b), iters=iters,
        x0=None if x0 is None else torch.from_numpy(x0), return_info=True)
    want, wrel, wk = jlin.pcg_solve(
        jnp.asarray(a), jnp.asarray(b), iters=iters,
        x0=None if x0 is None else jnp.asarray(x0), return_info=True)
    assert k == int(wk) == iters
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(rel.numpy(), np.asarray(wrel), rtol=1e-2,
                               atol=1e-4)


def test_pcg_solve_without_info_returns_the_iterate():
    a, b = spd_batch(5, 10, reg=1.0)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    x = plin.pcg_solve(ta, tb, iters=18)
    xi, _, _ = plin.pcg_solve(ta, tb, iters=18, return_info=True)
    assert torch.equal(x, xi)
    np.testing.assert_allclose(x.numpy(), ref_solve(a, b), rtol=2e-3,
                               atol=2e-3)


def test_pcg_early_exit_counts_like_jax():
    """`rtol` > 0 stops once every row's residual is small: the same
    iteration count as the JAX while_loop, and under the cap."""
    a, b = spd_batch(6, 32, reg=2.0, seed=3)
    got, rel, k = plin.pcg_solve(torch.from_numpy(a), torch.from_numpy(b),
                                 iters=64, rtol=1e-4, return_info=True)
    want, wrel, wk = jlin.pcg_solve(jnp.asarray(a), jnp.asarray(b),
                                    iters=64, rtol=1e-4, return_info=True)
    assert k == int(wk) < 64
    assert float(rel.max()) < 1e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_pcg_identity_padding_rows_converge_to_zero():
    a = np.broadcast_to(np.eye(8, dtype=np.float32), (3, 8, 8)).copy()
    b = np.zeros((3, 8), np.float32)
    x, rel, _ = plin.pcg_solve(torch.from_numpy(a), torch.from_numpy(b),
                               return_info=True)
    assert torch.equal(x, torch.zeros(3, 8)) and torch.equal(rel,
                                                             torch.zeros(3))


def als_systems(B=64, R=64, seed=0):
    """Normal equations shaped as the ALS ones: abs-normal / sqrt(R)
    factor rows, 20-80 ratings of 1-5 stars, ALS-WR diagonal."""
    rng = np.random.default_rng(seed)
    y = (np.abs(rng.standard_normal((2000, R))) / np.sqrt(R)).astype(
        np.float32)
    a = np.empty((B, R, R), np.float32)
    b = np.empty((B, R), np.float32)
    for j in range(B):
        n = int(rng.integers(20, 80))
        yu = y[rng.choice(2000, n, replace=False)]
        a[j] = yu.T @ yu + 0.05 * n * np.eye(R, dtype=np.float32)
        b[j] = yu.T @ rng.integers(1, 6, n).astype(np.float32)
    return a, b


def test_pcg_stays_put_after_convergence():
    """Hundreds of steps past convergence leave the solution where it
    converged: dot products below the smallest normal fp32 count as zero
    (the JAX package's backends flush denormals), so a denormal r.z
    cannot blow up beta."""
    a, b = als_systems()
    x, rel, _ = plin.pcg_solve(torch.from_numpy(a), torch.from_numpy(b),
                               iters=256, return_info=True)
    assert bool(torch.isfinite(x).all()) and float(rel.max()) < 1e-5
    np.testing.assert_allclose(x.numpy(), ref_solve(a, b), rtol=2e-4,
                               atol=2e-4)


def test_exact_fp32_restores_the_callers_setting():
    """`exact_fp32` never changes the flag: with TF32 on it refuses to
    run and the caller's setting stays; with it off the block runs."""
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="TF32 is on"):
            with plin.exact_fp32():
                pass
        assert torch.backends.cuda.matmul.allow_tf32 is True
        torch.backends.cuda.matmul.allow_tf32 = False
        with plin.exact_fp32():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_tf32_is_set_off_where_the_device_is_resolved():
    """A process that had TF32 on: resolving a device turns it off, and
    neither a generic `topk_scores` product nor a solve turns it back
    on."""
    from predictionio_tpu_torch import device as pdev
    from predictionio_tpu_torch.ops import topk as pt
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        assert pdev.resolve_device("cpu").type == "cpu"
        assert torch.backends.cuda.matmul.allow_tf32 is False
        x = torch.ones((2, 3))
        pt.topk_scores(x, torch.ones((5, 3)), torch.ones((2, 5), dtype=bool),
                       k=2)
        assert torch.backends.cuda.matmul.allow_tf32 is False
        a, b = spd_batch(2, 4)
        port_spd(a, b)
        plin.pcg_solve(torch.from_numpy(a), torch.from_numpy(b), iters=4)
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_tf32_stays_off_with_a_solve_and_a_product_in_two_threads(
        monkeypatch):
    """One thread solves (CG and Cholesky) while another runs the
    generic product, in a process that had TF32 on before its first
    entry point: the flag, sampled inside the solve's matvecs and around
    every product, is never on."""
    import sys
    import threading

    from predictionio_tpu_torch import device as pdev
    from predictionio_tpu_torch.ops import topk as pt
    seen = []
    matvec = plin._matvec

    def sampling_matvec(a, v):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return matvec(a, v)

    monkeypatch.setattr(plin, "_matvec", sampling_matvec)
    a, b = spd_batch(4, 20)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    x, items = torch.ones((3, 8)), torch.ones((40, 8))
    mask = torch.ones((3, 40), dtype=bool)
    saved = torch.backends.cuda.matmul.allow_tf32
    interval = sys.getswitchinterval()
    stop = threading.Event()

    def solver():
        while not stop.is_set():
            plin.pcg_solve(ta, tb, iters=3)
            plin.spd_solve(ta, tb)

    def product():
        for _ in range(300):
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            pt.topk_scores(x, items, mask, k=3)
            seen.append(torch.backends.cuda.matmul.allow_tf32)

    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        pdev.resolve_device("cpu")
        sys.setswitchinterval(1e-5)
        threads = [threading.Thread(target=solver, name="solve"),
                   threading.Thread(target=product, name="product")]
        threads[0].start()
        threads[1].start()
        threads[1].join(60)
        stop.set()
        threads[0].join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert len(seen) > 600 and not any(seen)
