"""Batched dense linear algebra for the ALS normal equations.

The port of `predictionio_tpu/ops/linalg.py`. The JAX package builds its
exact solve from unrolled 16-wide blocks with identity padding because
XLA's batched Cholesky is slow on a TPU; here the exact solve is
`torch.linalg.cholesky_ex` + `torch.cholesky_solve` (the `_ex` form
reports failures in a tensor instead of raising, so the solve needs no
host sync). `pcg_solve` is the same Jacobi-preconditioned conjugate
gradient, one system per batch element, with exact fp32 matvecs: the
JAX package's `matvec_precision` chose bf16 passes on the TPU and has no
counterpart here.

fp32 products on CUDA are exact only with TF32 off. The flag is
process-wide: `device.resolve_device` turns it off once, every entry
point resolves its device, and no code of the port turns it back on, so
a solve in one thread never changes it under a product in another.
`exact_fp32` checks it around a solve and refuses to run with TF32 on.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def exact_fp32() -> Iterator[None]:
    """A block of fp32 matrix products that must be exact: raises when
    TF32 is on (CUDA's cuBLAS would round their inputs to 10 mantissa
    bits), and leaves the flag as the caller set it."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "TF32 is on for fp32 matrix products; the port's solves need "
            "exact fp32 (resolve_device turns it off; do not turn it on "
            "in a process that trains or folds with the port)")
    yield


def _matvec(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """a @ v for the symmetric `a` CG takes, computed as (v^T a)^T: the
    same vector, and on the H100 cuBLAS's batched gemv runs this
    orientation faster (`chip_smoke.py` phase train prints both)."""
    return torch.bmm(v.unsqueeze(1), a).squeeze(1)


# smallest normal fp32. CG's dot products below it count as zero, as on
# the JAX package's CPU and TPU backends, which flush denormals: once a
# row has converged, a denormal r.z read as nonzero gives beta = 1e6 or
# more, and p (then x) blows up over the next iterations
_TINY = torch.finfo(torch.float32).tiny


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Row-wise u.v (>= 0 for the CG terms), zero below `_TINY`."""
    return torch.nn.functional.threshold(torch.linalg.vecdot(u, v), _TINY,
                                         0.0)


def spd_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a batch of SPD systems a @ x = b exactly.

    a: [B, R, R] SPD (well-regularized, e.g. ALS-WR normal equations),
    b: [B, R]. Like LAPACK POTRF, only the LOWER triangle of `a` is
    read: the upper one is rebuilt from it before the factorization.
    A system that is not SPD yields non-finite rows (no exception)."""
    with exact_fp32():
        low = torch.tril(a)
        sym = low + torch.tril(a, -1).mT
        chol, _ = torch.linalg.cholesky_ex(sym)
        return torch.cholesky_solve(b.unsqueeze(-1), chol).squeeze(-1)


def pcg_solve(a: torch.Tensor, b: torch.Tensor, *, iters: int = 32,
              x0: Optional[torch.Tensor] = None, rtol: float = 0.0,
              return_info: bool = False):
    """Jacobi-preconditioned conjugate gradient for a batch of SPD
    systems (`a` [B, R, R] symmetric, full matrix read; `b` [B, R]);
    rows with a == I, b == 0 (padding) converge to 0 in one step. Each
    batch element has its own CG scalars.

    `x0` warm-starts the iteration. With `rtol` == 0 the loop runs
    exactly `iters` steps and never waits on the device. `rtol` > 0
    adds an early exit once EVERY row's recurrence residual norm is
    below rtol * ||b||, checked on the host before each step; `iters`
    stays the hard cap. With `return_info=True` returns (x,
    rel_residual [B], iterations run), the residual from one extra
    true matvec, not the recurrence, which drifts."""
    with exact_fp32():
        diag = torch.diagonal(a, dim1=-2, dim2=-1)
        inv_d = 1.0 / diag.clamp_min(1e-30)
        if x0 is None:
            x = torch.zeros_like(b)
            r = b.clone()
        else:
            x = x0.clone()
            r = b - _matvec(a, x0)
        z = inv_d * r
        p = z
        rz = _dot(r, z)
        bnorm2 = torch.linalg.vecdot(b, b)
        k = 0
        while k < iters:
            if rtol > 0.0:
                rnorm2 = torch.linalg.vecdot(r, r)
                if not bool((rnorm2 > (rtol * rtol) * bnorm2).any()):
                    break
            ap = _matvec(a, p)
            denom = _dot(p, ap)
            alpha = (rz / torch.where(denom > 0, denom, 1.0)).unsqueeze(-1)
            x = x.addcmul(alpha, p)
            r = r.addcmul(alpha, ap, value=-1.0)
            z = inv_d * r
            rz_new = _dot(r, z)
            beta = (rz_new / torch.where(rz > 0, rz, 1.0)).unsqueeze(-1)
            p = z.addcmul(beta, p)
            rz = rz_new
            k += 1
        if not return_info:
            return x
        true_r = b - _matvec(a, x)
        rel = torch.sqrt(torch.linalg.vecdot(true_r, true_r)
                         / bnorm2.clamp_min(1e-30))
        return x, rel, k
