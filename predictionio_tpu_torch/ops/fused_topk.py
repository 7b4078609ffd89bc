"""Fused serve kernel: matmul -> ban/valid mask -> top-k in one call.

The port of `predictionio_tpu/ops/fused_topk.py`. The kernel is CUDA
C++ for Hopper (`csrc/fused_topk.cu`, two launches per call: persistent
blocks that stream factor tiles through a cp.async ring and keep a
running top-k per row with a threshold, then a per-row merge of the
blocks' lists), built with nvcc at first use into `_build/` and bound
with ctypes. Beside it:

  - `fused_topk_reference`, the plain PyTorch version of the same
    function. The wrapper runs it for tensors on the CPU, and only
    there; for CUDA tensors it launches the kernel or raises. There is
    no fallback and no switch: the JAX package's `PIO_SERVE_FUSED` gate
    has no counterpart here.
  - `LAUNCHES`, a count of wrapper calls that launched the kernel, so a
    run can show that its serving path went through it.
  - `shard_local_candidates`, the sharded form (the JAX package's
    `_kernel_dynamic`): the same kernel launched on one shard's rows
    with that shard's `n_valid` and first global row `id_base`, reading
    the GLOBAL bans and emitting global ids; counted in `LAUNCHES` and,
    for that call site alone, in `SHARD_LAUNCHES`. The two TPU kernels
    share one body and differ only in where `n_valid` comes from; the
    launcher takes it at run time, so K2 is a call site, not a second
    kernel.

Semantics (both versions): `scores = vecs @ factors^T` in exact fp32;
ids >= `n_valid` and each row's banned ids score `NEG_INF`. A banned id
g names row g - `id_base`, and matches nothing when that row is outside
0..n_rows-1 (the `n_items` filler, another shard's ids); rows are
ranked by (score desc, id asc), `lax.top_k`'s lowest-index tie-break,
so a banned item is still emitted when fewer than k others remain; the
ids returned are row + `id_base`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

from predictionio_tpu_torch.ops.topk import NEG_INF, _next_pow2, _topk_rows

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "fused_topk.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DEFAULT_CUDA_HOME = "/usr/local/cuda"

# limits of the kernel (csrc/fused_topk.cu kMaxK, kMaxBucket)
MAX_K = 64
MAX_BUCKET = 128
# pass 1: a ring of 2-4 stages of factor tiles, the bucket's queries and
# a running list per (warp, row) in one block's shared memory
_MAX_SMEM = 227 * 1024
_WARPS = 8
_BUF = 32      # buffered candidates per (warp, row)
MIN_STAGES = 2
# the scratch holds one list per block; the launcher clamps its grid to
# SM count x this
MAX_BLOCKS_PER_SM = 4

LAUNCHES = 0
SHARD_LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()
_SMS: dict = {}
_SLOTS: dict = {}   # device index -> [bound slots, last generation]


def fused_topk_reference(vecs: torch.Tensor, factors: torch.Tensor,
                         banned: torch.Tensor, *, k: int, n_valid: int,
                         id_base: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel, on any device:
    (scores [b, k] f32, ids + `id_base` [b, k] i32)."""
    # exact fp32 product, as the kernel: TF32 is off (resolve_device)
    scores = torch.matmul(vecs, factors.T)
    n_rows = factors.shape[0]
    ids = torch.arange(n_rows, device=scores.device)
    scores = scores.masked_fill(ids >= n_valid, NEG_INF)
    if k > n_rows:   # the kernel's tiles hold ids past the catalog, masked
        pad = scores.new_full((scores.shape[0], k - n_rows), NEG_INF)
        scores = torch.cat([scores, pad], dim=1)
    ban = banned.to(torch.int64) - id_base
    keep = (ban >= 0) & (ban < n_rows)
    rows = torch.arange(ban.shape[0], device=ban.device)[:, None]
    rows = rows.expand_as(ban)
    scores[rows[keep], ban[keep]] = NEG_INF
    top_s, top_i = _topk_rows(scores, k)
    return top_s, top_i + id_base


def _config(bucket: int) -> Tuple[int, int, int, int]:
    """The kernel's thread mapping for a bucket (`config_for` in
    csrc/fused_topk.cu): (items per tile, warps splitting a tile's
    items, items per lane, rows per warp)."""
    if bucket <= 1:
        return 256, 8, 1, 1
    if bucket <= 2:
        return 256, 4, 2, 1
    if bucket <= 4:
        return 256, 2, 4, 1
    return 128, 1, 4, _next_pow2(-(-bucket // _WARPS))


def _smem_bytes(bucket: int, rank: int, k: int, stages: int) -> int:
    """Pass 1's shared memory (`smem_bytes` in csrc/fused_topk.cu):
    the factor ring at an odd stride of 16-byte chunks, the queries and
    the (warp, row) lists of (key, ~id) pairs."""
    tile, wi, _, rpt = _config(bucket)
    rank4 = -(-rank // 4) * 4
    fstride = 4 * ((rank4 // 4) | 1)
    return (4 * (stages * tile * fstride + _WARPS // wi * rpt * rank4)
            + 8 * _WARPS * rpt * (k + _BUF))


def _max_blocks(idx: int) -> int:
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx] * MAX_BLOCKS_PER_SM


def _bound_slots(idx: int) -> Tuple[torch.Tensor, int]:
    """The card's bound slots (`MAX_BUCKET * MAX_K` words the kernel
    keeps across calls) and this call's generation, above every earlier
    one on them. The slots are zeroed, and the card synchronised so that
    every stream sees the zeros, when made and when the 32-bit
    generation wraps; they are zeroed in place, since a kernel on
    another stream may still be writing them."""
    with _LAUNCH_LOCK:
        ent = _SLOTS.get(idx)
        if ent is None:
            ent = _SLOTS[idx] = [
                torch.zeros(MAX_BUCKET * MAX_K, dtype=torch.int64,
                            device=torch.device("cuda", idx)), 0]
            torch.cuda.synchronize(idx)
        elif ent[1] == 2**32 - 1:
            torch.cuda.synchronize(idx)
            ent[0].zero_()
            torch.cuda.synchronize(idx)
            ent[1] = 0
        ent[1] += 1
        return ent[0], ent[1]


def fused_topk(vecs: torch.Tensor, factors: torch.Tensor,
               banned: torch.Tensor, *, k: int, n_valid: int,
               id_base: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of `vecs [b, rank] @ factors[n_rows, rank]^T` under the
    per-row `banned [b, W]` ids (row + `id_base`) and the `n_valid` row
    bound; ids come back as row + `id_base`. CPU tensors take the plain
    version; CUDA tensors launch the kernel (and count in `LAUNCHES`) or
    raise. Returns device tensors without synchronising."""
    devices = {vecs.device, factors.device, banned.device}
    if len(devices) != 1:
        raise ValueError(f"fused_topk: tensors on several devices {devices}")
    dev = vecs.device
    if dev.type == "cpu":
        return fused_topk_reference(vecs, factors, banned, k=k,
                                    n_valid=n_valid, id_base=id_base)
    if dev.type != "cuda":
        raise ValueError(f"fused_topk: no kernel for device {dev}")
    b, rank, n_rows, width = _check(vecs, factors, banned, k, n_valid,
                                    id_base)
    lib = load_library()
    with torch.cuda.device(dev):
        idx = torch.cuda.current_device()
        max_blocks = _max_blocks(idx)
        slots, gen = _bound_slots(idx)
        out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
        out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
        cand = torch.empty(b * max_blocks * k, dtype=torch.int64,
                           device=dev)
        err = lib.pio_fused_topk(
            vecs.data_ptr(), factors.data_ptr(), banned.data_ptr(),
            slots.data_ptr(), cand.data_ptr(), out_s.data_ptr(),
            out_i.data_ptr(), b, rank, n_rows, n_valid, width, k, id_base,
            max_blocks, gen, torch._C._cuda_getCurrentRawStream(idx))
    if err != 0:
        msg = lib.pio_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_topk launch failed ({err}): {msg}")
    global LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES += 1
    return out_s, out_i


def shard_local_candidates(vecs: torch.Tensor, factors_local: torch.Tensor,
                           banned: torch.Tensor, *, k: int, n_valid: int,
                           id_base: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's top-`k` candidates for `ShardedBucketedTopK`: the
    rows of `factors_local [per_shard, rank]`, global rows `id_base`
    onwards, scored against `vecs`; rows at or past `n_valid` and the
    GLOBAL ids in `banned` that fall on this shard at NEG_INF (other
    shards' ids and the `n_items` filler match nothing), ranked by
    (score desc, id asc). Returns (scores [b, k], global ids [b, k]) on
    the shard's device; merging across shards stays with the caller.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted) or raise."""
    if k > factors_local.shape[0]:
        raise ValueError(
            f"shard_local_candidates: k={k} above the shard's "
            f"{factors_local.shape[0]} rows; pass min(k, per_shard)")
    out = fused_topk(vecs, factors_local, banned, k=k, n_valid=n_valid,
                     id_base=id_base)
    if vecs.device.type == "cuda":
        global SHARD_LAUNCHES
        with _LAUNCH_LOCK:
            SHARD_LAUNCHES += 1
    return out


def _check(vecs, factors, banned, k: int, n_valid: int, id_base: int = 0):
    if vecs.dtype != torch.float32 or factors.dtype != torch.float32:
        raise TypeError("fused_topk: vecs and factors must be float32")
    if banned.dtype != torch.int32:
        raise TypeError("fused_topk: banned must be int32")
    if vecs.dim() != 2 or factors.dim() != 2 or banned.dim() != 2:
        raise ValueError("fused_topk: vecs, factors, banned must be 2-D")
    b, rank = vecs.shape
    n_rows = factors.shape[0]
    if factors.shape[1] != rank or banned.shape[0] != b:
        raise ValueError(
            f"fused_topk: shapes vecs {tuple(vecs.shape)}, factors "
            f"{tuple(factors.shape)}, banned {tuple(banned.shape)} disagree")
    if not (vecs.is_contiguous() and factors.is_contiguous()
            and banned.is_contiguous()):
        raise ValueError("fused_topk: inputs must be contiguous")
    if not 1 <= b <= MAX_BUCKET:
        raise ValueError(f"fused_topk: bucket {b} outside 1..{MAX_BUCKET}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"fused_topk: k={k} outside 1..{MAX_K}")
    if n_rows < 1 or not 0 <= n_valid <= n_rows:
        raise ValueError(
            f"fused_topk: n_valid={n_valid} outside 0..n_rows={n_rows}")
    if not 0 <= id_base <= 2**31 - 1 - n_rows:
        raise ValueError(
            f"fused_topk: id_base={id_base} + {n_rows} rows past int32")
    if _smem_bytes(b, rank, k, MIN_STAGES) > _MAX_SMEM:
        raise ValueError(
            f"fused_topk: rank {rank} x bucket {b} x k {k} needs more "
            "shared memory than a block has")
    return b, rank, n_rows, banned.shape[1]


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 DEFAULT_CUDA_HOME):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, CUDA_PATH, "
        f"{DEFAULT_CUDA_HOME}): the fused_topk kernel cannot be built")


def build_library() -> Path:
    """Compile `csrc/fused_topk.cu` for sm_90a into `_build/`, named by
    the source's hash so an edited source rebuilds; returns the shared
    library's path. nvcc's output (ptxas register and shared-memory
    report included) lands beside it as a `.log`. Raises on failure."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"fused_topk_{digest}.so"
    if lib.is_file():
        return lib
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"fused_topk_{digest}.{os.getpid()}.tmp.so"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, check=False)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode} building {SOURCE}:\n"
            f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib)   # atomic: a concurrent build never sees half a file
    return lib


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            ptr, i = ctypes.c_void_p, ctypes.c_int
            lib.pio_fused_topk.argtypes = ([ptr] * 7 + [i] * 8
                                           + [ctypes.c_uint, ptr])
            lib.pio_fused_topk.restype = i
            lib.pio_fused_topk_plan.argtypes = [i] * 5 + [ptr]
            lib.pio_fused_topk_plan.restype = i
            lib.pio_fused_topk_smem_bytes.argtypes = [i] * 4
            lib.pio_fused_topk_smem_bytes.restype = ctypes.c_longlong
            lib.pio_cuda_error_string.argtypes = [i]
            lib.pio_cuda_error_string.restype = ctypes.c_char_p
            for name in ("pio_fused_topk_max_k", "pio_fused_topk_max_bucket"):
                getattr(lib, name).argtypes = []
                getattr(lib, name).restype = i
            limits = (lib.pio_fused_topk_max_k(),
                      lib.pio_fused_topk_max_bucket())
            if limits != (MAX_K, MAX_BUCKET):
                raise RuntimeError(
                    f"fused_topk library limits {limits} != wrapper's "
                    f"{(MAX_K, MAX_BUCKET)}")
            for b, rank, k in ((1, 64, 10), (8, 10, 64), (128, 64, 64)):
                got = lib.pio_fused_topk_smem_bytes(b, rank, k, MIN_STAGES)
                if got != _smem_bytes(b, rank, k, MIN_STAGES):
                    raise RuntimeError(
                        f"fused_topk library shared memory {got} != "
                        f"wrapper's {_smem_bytes(b, rank, k, MIN_STAGES)}")
            _LIB = lib
        return _LIB


def launch_plan(bucket: int, rank: int, k: int, n_rows: int,
                device=None) -> dict:
    """The kernel's launch plan on a CUDA device for these shapes: SM
    count, blocks per SM, ring stages, grid, pass-1 shared bytes and
    items per tile. Raises where the library does."""
    dev = torch.device(device if device is not None else "cuda")
    lib = load_library()
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(dev):
        max_blocks = _max_blocks(torch.cuda.current_device())
        err = lib.pio_fused_topk_plan(bucket, rank, k, n_rows, max_blocks,
                                      out)
    if err != 0:
        raise RuntimeError(f"fused_topk plan failed ({err}): "
                           f"{lib.pio_cuda_error_string(err).decode()}")
    return dict(zip(("sms", "blocks_per_sm", "stages", "grid", "smem_bytes",
                     "tile_items"), out))
