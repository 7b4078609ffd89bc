#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`predictionio_tpu_torch`).

    python3 chip_smoke.py [--seed 0] [--requests 320]

Needs one CUDA card; imports nothing of JAX or of `predictionio_tpu`.
Phases, each printing one JSON line; any failure exits non-zero before
the result line:

  1. env      torch / CUDA versions and the card (nvidia-smi name, power
              limit).
  2. build    nvcc builds the fused top-k kernel from csrc/ (sm_90a).
  3. parity   kernel vs its plain PyTorch version on the card:
              bit-identical on integer-valued factors (rank 10 and 64,
              buckets 1/8/64, bans straddling tiles, an all-banned row,
              n_valid < n_items); on real-valued factors at 500,000 x 64
              the scores agree to rtol=atol=1e-5 (fp32 summation order
              differs) and ids agree except inside such near-ties.
  4. serve    the serving path at full width: a 162,541-user x
              500,000-item rank-64 ALS model made from --seed, deployed
              through `cli.main.deploy` (the code `cli deploy` runs) and
              hit by concurrent /queries.json requests; every answer is
              checked against the plain version on the card, and the
              kernel's launch count over the run must equal the bucket
              calls the plan made (warmup + one per drained batch chunk).
  5. timing   kernel, plain-version and library-chain times (CUDA events)
              at 500,000 x 64, k=10, W=64, buckets 1 and 64, beside the
              card's bound max(bytes / HBM rate, flops / fp32 rate).

Then the kernels line, the nvidia-smi line and, last,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

N_USERS = 162_541    # MovieLens-25M users
N_ITEMS = 500_000    # the large-catalog serving case
RANK = 64
K = 10               # the recommendation template's plan k
WIDTH = 64           # its banned width
TOL = 1e-5

# (HBM bytes/s, fp32 CUDA-core FLOP/s) from NVIDIA's data sheets, dense,
# at the part's full power limit; matched on the nvidia-smi name
PEAKS = (("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12),
         ("H200", 4.8e12, 67e12), ("H100", 3.35e12, 67e12))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def peaks(name: str):
    for key, bw, fl in PEAKS:
        if key in name:
            return bw, fl
    fail(f"no published peak rates for card {name!r}")


def agree(ks, ki, rs, ri, exact) -> float:
    """Kernel (scores, ids) vs plain (scores, ids), host arrays, with
    `exact` the fp64 scores of the kernel's ids. Scores agree within TOL
    elementwise; where the ids differ, the kernel's item must truly score
    within TOL of the plain version's at that rank (a near-tie the two
    fp32 summation orders break differently). Returns max |score diff|."""
    err = np.abs(ks.astype(np.float64) - rs)
    if not np.all(err <= TOL + TOL * np.abs(rs)):
        fail(f"scores disagree: max abs err {err.max()}")
    for row in range(ks.shape[0]):
        if len(set(ki[row].tolist())) != ki.shape[1]:
            fail(f"row {row}: duplicate ids {ki[row].tolist()}")
        for j in np.nonzero(ki[row] != ri[row])[0]:
            if not abs(exact[row, j] - rs[row, j]) <= TOL + TOL * abs(
                    rs[row, j]):
                fail(f"row {row} rank {j}: kernel id {ki[row, j]} (true "
                     f"score {exact[row, j]}) vs plain id {ri[row, j]} "
                     f"({rs[row, j]}) is no near-tie")
    return float(err.max()) if err.size else 0.0


def exact_scores(torch, vecs, factors, ids):
    """fp64 scores of item `ids` [b, k] for query rows `vecs` [b, rank]."""
    ids_t = torch.as_tensor(ids, dtype=torch.long, device=factors.device)
    return (factors[ids_t].double() * vecs.double()[:, None, :]).sum(
        -1).cpu().numpy()


def phase_parity(torch, ft, dev, rng) -> float:
    def run(n, rank, b, k, n_valid, bans, integer):
        if integer:
            f = rng.integers(-4, 5, (n, rank)).astype(np.float32)
            v = rng.integers(-4, 5, (b, rank)).astype(np.float32)
        else:
            f = rng.standard_normal((n, rank), dtype=np.float32)
            v = rng.standard_normal((b, rank), dtype=np.float32)
        ban = np.full((b, WIDTH), n, np.int32)
        for row in range(b):
            ids = bans[row % len(bans)][:WIDTH]
            ban[row, :len(ids)] = ids
        ft_, vt, bt = (torch.from_numpy(x).to(dev) for x in (f, v, ban))
        s, i = ft.fused_topk(vt, ft_, bt, k=k, n_valid=n_valid)
        torch.cuda.synchronize()
        rs, ri = ft.fused_topk_reference(vt, ft_, bt, k=k, n_valid=n_valid)
        torch.cuda.synchronize()
        s, i, rs, ri = (x.cpu().numpy() for x in (s, i, rs, ri))
        if integer:
            if not (np.array_equal(i, ri) and np.array_equal(s, rs)):
                fail(f"not bit-identical: n={n} rank={rank} bucket={b} "
                     f"k={k} n_valid={n_valid}")
            return 0.0
        return agree(s, i, rs.astype(np.float64), ri,
                     exact_scores(torch, vt, ft_, i))

    n = 20_037   # ragged last tile
    straddle = [[], list(range(120, 136)), list(range(500, 530)),
                list(range(n - 40, n)), [127, 128, 255, 256, 511, 512]]
    cases = 0
    for rank in (10, 64):
        for b in (1, 8, 64):
            for n_valid in (n, n - 1000, 5):
                run(n, rank, b, K, n_valid, straddle, True)
                cases += 1
    run(60, 10, 8, K, 60, [list(range(60)), []], True)   # all-banned row
    run(n, 64, 64, 64, n, straddle, True)                # the largest k
    cases += 2
    err = run(N_ITEMS, RANK, 64, K, N_ITEMS,
              [sorted(rng.choice(N_ITEMS, WIDTH, replace=False).tolist())],
              False)
    emit({"phase": "parity", "integer_cases": cases, "bit_identical": True,
          "real_valued": {"n_items": N_ITEMS, "rank": RANK, "bucket": 64,
                          "max_abs_err": err, "tol": TOL}})
    return err


def phase_serve(torch, ft, dev, rng, n_requests: int) -> dict:
    from predictionio_tpu_torch.cli.main import deploy
    from predictionio_tpu_torch.ops.als import als_model_from_numpy
    from predictionio_tpu_torch.ops.topk import NEG_INF

    t0 = time.perf_counter()
    # normal / sqrt(rank), as bench.py's large-catalog serving case
    model = als_model_from_numpy(
        rng.standard_normal((N_USERS, RANK), dtype=np.float32) / 8.0,
        rng.standard_normal((N_ITEMS, RANK), dtype=np.float32) / 8.0,
        [f"u{n}" for n in range(N_USERS)], [f"i{n}" for n in range(N_ITEMS)],
        device="cuda")
    setup_s = time.perf_counter() - t0

    users = rng.integers(0, N_USERS, n_requests)
    nums = rng.integers(1, K + 1, n_requests)
    # a quarter of the queries ban their own top items (the bans must
    # change the answer), others random spans of up to WIDTH ids
    rows = torch.from_numpy(users).to(dev)
    none = torch.full((n_requests, 1), N_ITEMS, dtype=torch.int32,
                      device=dev)
    _, top = ft.fused_topk_reference(model.user_factors[rows],
                                     model.item_factors, none, k=K,
                                     n_valid=N_ITEMS)
    top = top.cpu().numpy()
    queries = []
    for r in range(n_requests):
        q = {"user": f"u{users[r]}", "num": int(nums[r])}
        if r % 4 == 1:
            extra = rng.choice(N_ITEMS, WIDTH - 5, replace=False)
            q["blackList"] = [f"i{x}" for x in [*top[r, :5], *extra]]
        elif r % 4 == 2:
            lo = int(rng.integers(0, N_ITEMS - WIDTH))
            q["blackList"] = [f"i{x}" for x in
                              range(lo, lo + int(rng.integers(1, WIDTH)))]
        queries.append(q)

    ft.LAUNCHES = 0          # the count covers the main path only
    t0 = time.perf_counter()
    server = deploy(model, port=0, batch_max=64)
    warm_s = time.perf_counter() - t0
    plan = server.deployment.algos[0]._serve_plan
    # host time inside the drainer's scoring calls, for the breakdown
    batch_s = []
    predict = server.deployment.predict_batch

    def timed_predict(queries):
        t = time.perf_counter()
        try:
            return predict(queries)
        finally:
            batch_s.append(time.perf_counter() - t)

    server.deployment.predict_batch = timed_predict

    def post(q):
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/queries.json",
            data=json.dumps(q).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = json.loads(resp.read())
        return body, time.perf_counter() - t

    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(64) as pool:
            answers = list(pool.map(post, queries))
        wall_s = time.perf_counter() - t0
        launches, plan_calls = ft.LAUNCHES, plan.calls
        sizes = server.batcher.batch_sizes()
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/",
                                    timeout=60) as resp:
            status = json.loads(resp.read())
    finally:
        server.stop()
        server.deployment.predict_batch = predict
    # the same scoring call without the HTTP threads around it: 50
    # sequential batches of 5 queries
    from predictionio_tpu_torch.models.recommendation import Query
    batch = [Query(**q) for q in queries[:5]]
    predict(batch)
    t0 = time.perf_counter()
    for _ in range(50):
        predict(batch)
    alone_ms = 1e3 * (time.perf_counter() - t0) / 50
    expected = len(plan.buckets) + sum(
        c * -(-n // plan.max_bucket) for n, c in sizes.items())
    if not (launches == plan_calls == expected):
        fail(f"kernel launches {launches}, plan calls {plan_calls}, "
             f"expected {expected} (warmup + drained batch chunks)")
    if sum(n * c for n, c in sizes.items()) != n_requests:
        fail(f"batches {sizes} do not add up to {n_requests} requests")

    # every answer against the plain version on the card
    banned = np.full((n_requests, WIDTH), N_ITEMS, np.int32)
    for r, q in enumerate(queries):
        ids = [int(x[1:]) for x in q.get("blackList", ())]
        banned[r, :len(ids)] = ids
    bad = 0
    max_err = 0.0
    for lo in range(0, n_requests, 64):
        sl = slice(lo, lo + 64)
        rs, ri = ft.fused_topk_reference(
            model.user_factors[rows[sl]], model.item_factors,
            torch.from_numpy(banned[sl]).to(dev), k=K, n_valid=N_ITEMS)
        rs, ri = rs.double().cpu().numpy(), ri.cpu().numpy()
        for j, r in enumerate(range(lo, min(lo + 64, n_requests))):
            got = answers[r][0]["itemScores"]
            keep = [c for c in range(K) if rs[j, c] > NEG_INF / 2][:nums[r]]
            if len(got) != len(keep):
                bad += 1
                continue
            ks = np.array([[g["score"] for g in got]])
            ki = np.array([[int(g["item"][1:]) for g in got]])
            exact = exact_scores(torch, model.user_factors[rows[r:r + 1]],
                                 model.item_factors, ki)
            max_err = max(max_err, agree(ks, ki, rs[j:j + 1, :len(got)],
                                         ri[j:j + 1, :len(got)], exact))
    if bad:
        fail(f"{bad} of {n_requests} answers have the wrong length")
    lat = np.sort([t for _, t in answers])
    out = {"phase": "serve", "users": N_USERS, "items": N_ITEMS,
           "rank": RANK, "requests": n_requests, "answers_checked":
           n_requests, "max_abs_err": max_err,
           "batch_sizes": {str(n): c for n, c in sorted(sizes.items())},
           "drained_batches": sum(sizes.values()),
           "warmed_buckets": list(plan.buckets), "launches": launches,
           "plan_calls": plan_calls,
           "status_kernel_launches": status["kernel_launches"],
           "model_setup_s": setup_s,
           "deploy_warm_s": warm_s, "wall_s": wall_s,
           "predict_batch_s": {"sum": sum(batch_s),
                               "mean": sum(batch_s) / len(batch_s)},
           "predict_batch_alone_ms": alone_ms,
           "qps": n_requests / wall_s,
           "latency_ms": {"p50": 1e3 * lat[len(lat) // 2],
                          "p99": 1e3 * lat[int(0.99 * (len(lat) - 1))]}}
    emit(out)
    return out


def time_ms(torch, fn, iters: int) -> float:
    for _ in range(3):
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


def phase_timing(torch, ft, dev, rng, card: str) -> dict:
    from predictionio_tpu_torch.ops.topk import NEG_INF
    bw, fl = peaks(card)
    factors = torch.from_numpy(
        rng.standard_normal((N_ITEMS, RANK), dtype=np.float32)).to(dev)
    out = {}
    for b in (1, 64):
        vecs = torch.from_numpy(
            rng.standard_normal((b, RANK), dtype=np.float32)).to(dev)
        banned = torch.from_numpy(np.stack(
            [rng.choice(N_ITEMS, WIDTH, replace=False) for _ in range(b)]
        ).astype(np.int32)).to(dev)
        banned64 = banned.long()

        def library():
            s = torch.matmul(vecs, factors.T)
            s.scatter_(1, banned64, NEG_INF)
            return torch.topk(s, K)

        kernel_ms = time_ms(torch, lambda: ft.fused_topk(
            vecs, factors, banned, k=K, n_valid=N_ITEMS), 50)
        plain_ms = time_ms(torch, lambda: ft.fused_topk_reference(
            vecs, factors, banned, k=K, n_valid=N_ITEMS), 20)
        library_ms = time_ms(torch, library, 20)
        nbytes = 4 * (N_ITEMS * RANK + b * RANK + b * WIDTH) + 8 * b * K
        flops = 2 * b * N_ITEMS * RANK
        t_bytes, t_ops = nbytes / bw, flops / fl
        row = {"bucket": b, "ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_us": 1e6 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "flops": flops}
        emit({"phase": "timing", "card": card, **row})
        out[b] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=320)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs a card",
              file=sys.stderr)
        return 2
    from predictionio_tpu_torch.ops import fused_topk as ft

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # exact fp32 products
    torch.backends.cudnn.allow_tf32 = False
    card = smi_line()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card})

    t0 = time.perf_counter()
    lib = ft.build_library()
    ft.load_library()
    log = lib.with_suffix(".log").read_text()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": lib.name,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    rng = np.random.default_rng(args.seed)
    err = phase_parity(torch, ft, dev, rng)
    serve = phase_serve(torch, ft, dev, rng, args.requests)
    timing = phase_timing(torch, ft, dev, rng, card)

    main_row = timing[64]
    emit({"kernels": [{
        "name": "fused_topk", "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/fused_topk.cu",
        "replaces": "predictionio_tpu/ops/fused_topk.py:206",
        "launches": serve["launches"],
        "max_abs_err": max(err, serve["max_abs_err"]),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"], "bucket": 64,
        "by_bucket": {str(b): r for b, r in timing.items()}}]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
