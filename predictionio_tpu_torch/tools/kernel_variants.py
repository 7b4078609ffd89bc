"""Design probes of the fused top-k kernel on the card.

    python -m predictionio_tpu_torch.tools.kernel_variants [variant ...]

Builds `csrc/fused_topk.cu` and variants of it made by exact text
patches (a patch whose anchor is missing raises, so a probe fails
loudly once the kernel changes under it) and times each with CUDA
events at 500,000 x 64, k = 10, W = 64, buckets 1, 8 and 64, calling
the library directly rather than through the wrapper, so the host's
share is small. Prints one JSON line per (variant, bucket), then the
card's name and power limit. Variants (all by default):

  kernel            the kernel as it is
  count             the same, counting per call the scores buffered as
                    candidates and the buffer flushes
  product           the product and the copies alone, the selection
                    skipped (answers wrong): the floor the selection is
                    measured against
  no_bound          the row's bound slots never read
  bound_every_tile  the bound slots read on every tile

Needs one card and nvcc; nothing runs on import.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys

import numpy as np
import torch

from predictionio_tpu_torch.ops import fused_topk as ft

N_ITEMS, RANK, K, WIDTH = 500_000, 64, 10, 64
BUCKETS = (1, 8, 64)
ITERS = 200

_COUNTERS = """
__device__ unsigned long long g_candidates, g_flushes;
"""
_COUNT_API = """
extern "C" void pio_probe_counts(unsigned long long* out) {
  cudaMemcpyFromSymbol(&out[0], g_candidates, 8);
  cudaMemcpyFromSymbol(&out[1], g_flushes, 8);
  const unsigned long long zero = 0;
  cudaMemcpyToSymbol(g_candidates, &zero, 8);
  cudaMemcpyToSymbol(g_flushes, &zero, 8);
}
"""
_READ = "    const bool read_slots = (i & 7) == 1;\n"


def _sub(src: str, anchor: str, repl: str) -> str:
    if src.count(anchor) != 1:
        raise RuntimeError(f"anchor not found once in the kernel: {anchor!r}")
    return src.replace(anchor, repl)


def variant_source(name: str) -> str:
    src = ft.SOURCE.read_text()
    if name == "kernel":
        return src
    if name == "count":
        src = _sub(src, "namespace {\n", "namespace {\n" + _COUNTERS)
        src = _sub(src, "        nbuf[rr] += __popc(m);\n",
                   "        nbuf[rr] += __popc(m);\n        if (lane == 0) "
                   "atomicAdd(&g_candidates, "
                   "(unsigned long long)__popc(m));\n")
        src = _sub(src, "  unsigned long long c = 0ull;\n  if (lane < n) {",
                   "  if (lane == 0) atomicAdd(&g_flushes, 1ull);\n"
                   "  unsigned long long c = 0ull;\n  if (lane < n) {")
        return src + _COUNT_API
    if name == "product":
        a = src.index("    // the lane's item j of this tile is local row")
        b = src.index("  // epilogue: flush what is left")
        keep = """    unsigned x = 0;
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
      for (int j = 0; j < IPT; ++j) x ^= __float_as_uint(acc[rr][j]);
    if (x == 0x5a5a5a5au && fresh[0] == 1u) cand[0] = make_uint2(x, x);
  }

"""
        return src[:a] + keep + src[b:]
    if name == "no_bound":
        return _sub(src, _READ, "    const bool read_slots = false;\n")
    if name == "bound_every_tile":
        return _sub(src, _READ, "    const bool read_slots = true;\n")
    raise ValueError(f"unknown variant {name!r}")


def build(name: str) -> ctypes.CDLL:
    src = variant_source(name)
    digest = hashlib.sha256(src.encode()).hexdigest()[:16]
    ft.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = ft.BUILD_DIR / f"variant_{name}_{digest}.cu"
    so = cu.with_suffix(".so")
    if not so.is_file():
        cu.write_text(src)
        proc = subprocess.run([ft._find_nvcc(), *ft.NVCC_FLAGS, "-o",
                               str(so), str(cu)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {name}:\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(so))
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.pio_fused_topk.argtypes = [ptr] * 7 + [i] * 8 + [ctypes.c_uint, ptr]
    lib.pio_fused_topk.restype = i
    return lib


def time_ms(fn, iters: int) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv) -> int:
    names = argv or ["kernel", "count", "product", "no_bound",
                     "bound_every_tile"]
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    factors = torch.from_numpy(
        rng.standard_normal((N_ITEMS, RANK), dtype=np.float32)).to(dev)
    max_blocks = ft._max_blocks(0)
    slots = torch.zeros(ft.MAX_BUCKET * ft.MAX_K, dtype=torch.int64,
                        device=dev)
    torch.cuda.synchronize()
    gen = [0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]
    for name in names:
        lib = build(name)
        for b in BUCKETS:
            vecs = torch.from_numpy(
                rng.standard_normal((b, RANK), dtype=np.float32)).to(dev)
            banned = torch.from_numpy(np.stack(
                [rng.choice(N_ITEMS, WIDTH, replace=False)
                 for _ in range(b)]).astype(np.int32)).to(dev)
            cand = torch.empty(b * max_blocks * K, dtype=torch.int64,
                               device=dev)
            out_s = torch.empty((b, K), dtype=torch.float32, device=dev)
            out_i = torch.empty((b, K), dtype=torch.int32, device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream

            def call():
                gen[0] += 1
                err = lib.pio_fused_topk(
                    vecs.data_ptr(), factors.data_ptr(), banned.data_ptr(),
                    slots.data_ptr(), cand.data_ptr(), out_s.data_ptr(),
                    out_i.data_ptr(), b, RANK, N_ITEMS, N_ITEMS, WIDTH, K, 0,
                    max_blocks, gen[0], stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")

            row = {"variant": name, "bucket": b, "card": card,
                   "ms": time_ms(call, ITERS)}
            if name == "count":
                counts = (ctypes.c_ulonglong * 2)()
                lib.pio_probe_counts(counts)
                call()
                torch.cuda.synchronize()
                lib.pio_probe_counts(counts)
                row["candidates"], row["flushes"] = list(counts)
            if name != "product":
                call()
                _, ref_i = ft.fused_topk_reference(
                    vecs, factors, banned, k=K, n_valid=N_ITEMS)
                row["ids_match_plain"] = bool(torch.equal(out_i, ref_i))
            print(json.dumps(row), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
