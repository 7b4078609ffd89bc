#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`predictionio_tpu_torch`).

    python3 chip_smoke.py [--seed 0] [--requests 320]
                          [--sharded-requests 160] [--tiered-queries 64]
                          [--trained-requests 64] [--lifecycle-requests 320]
                          [--streaming-requests 320]
                          [--quickstart-requests 320]
                          [--templates-requests 64]
                          [--only serve_sharded | train | lifecycle |
                                  streaming | quickstart | templates]

Needs one CUDA card; imports nothing of JAX or of `predictionio_tpu`.
Phases, each printing one JSON line; any failure exits non-zero before
the result line:

  1. env      torch / CUDA versions and the card (nvidia-smi name, power
              limit).
  2. build    nvcc builds the fused top-k kernel from csrc/ (sm_90a);
              prints the launch plan per timed bucket (SM count, blocks
              per SM, ring stages, grid, shared bytes, items per tile)
              and ptxas's registers and spills.
  3. parity   kernel vs its plain PyTorch version on the card:
              bit-identical on integer-valued factors: rank 10 and 64,
              buckets 1/2/8/64/128, bans straddling tiles, n_valid <
              n_items; a 60-item catalog (one tile, one block) with an
              all-banned row; k = 64 at buckets 1/8/128; a 300,007-row
              catalog whose tile count is no multiple of the persistent
              grid, with bans on the first and last item of every
              block's range; MovieLens-1M's 3,706-item catalog, whose
              few tiles shrink the grid to one tile per block, banned
              alike; all-equal scores across block edges (the
              lowest ids must win); the e-commerce plan's shape, 50,000
              x 32 at W = 2,048 and buckets 1/8/64, its bans the 1,000
              even ids below 2,000 and a 100-1,000-id seen span over a
              block edge per row, padded with n_items. On real-valued
              factors at 500,000 x 64 the scores agree to rtol=atol=1e-5
              (fp32 summation order differs) and ids agree except inside
              such near-ties.
  4. serve    the serving path at full width: a 162,541-user x
              500,000-item rank-64 ALS model made from --seed, deployed
              through `cli.main.deploy` (the code `cli deploy` runs) and
              hit by concurrent /queries.json requests; every answer is
              checked against the plain version on the card, and the
              kernel's launch count over the run must equal the bucket
              calls the plan made (warmup + one per drained batch chunk).
              Between the two halves of the requests a new 500,000 x 64
              table goes into the live plan by `swap_factors` (ms per
              swap from a device tensor and from host RAM); the second
              half is checked against the new table.
  5. parity_sharded
              the kernel's sharded form (K2, `shard_local_candidates`)
              vs its plain version on shard slices of a 20,037-row
              catalog split 3 and 4 ways: n_valid of per_shard,
              per_shard - 1, 5 < k, 0 and the shard's own, local bans
              over the 128-row tiles, the filler per_shard, an
              all-banned row; bit-identical on integer factors. K2 as
              the plan launches it, with GLOBAL bans straddling every
              shard edge and the shard's `id_base`, must equal K2 on the
              translated local bans with its ids offset. Then the
              whole `ShardedBucketedTopK` at 3 shards on one card vs the
              plain version over the unsharded catalog: bit-identical on
              integer factors with ties across shard edges; on phase 4's
              real-valued 500,000 x 64 catalog within TOL of the plain
              version and bit-identical to the single-device kernel.
  6. serve_sharded
              phase 4's model and request mix deployed through
              `cli.main.deploy(model, mesh=ServeMesh((cuda:0,) * 3,
              forced=True))`: per_shard 166,667 with one padding row;
              the deploy must move the model's item master to host RAM.
              Every answer is checked against the plain version over the
              whole catalog, and the kernel's launches must equal
              n_shards x (warmed buckets + drained batch chunks), all of
              them K2's. With two or more cards, the same again with one
              shard per card.
  7. serve_tiered
              the same model with its item master in host RAM, deployed
              through `cli.main.deploy` under PIO_SERVE_TIER=on,
              PIO_TIER_HOT_FRAC=0.25: a 125,000-item hot slab through
              the kernel (the only catalog bytes the deploy adds on the
              card), the cold items on the host. /queries.json requests
              in two halves, checked as above, with one page pass
              (`PageManager.tick`: fold + `rebalance()`) between them
              that must swap the slab without launching or warming
              anything; GET / must show the tiered plan and stop() must
              join the page thread.
  8. timing   kernel, plain-version and library-chain times (CUDA events)
              at 500,000 x 64, k=10, W=64, buckets 1, 8 and 64, beside
              the card's bound max(bytes / HBM rate, flops / fp32
              rate); K2 the same at buckets 1 and 64 on the last
              166,667-row shard (n_valid 166,666, global bans, id_base
              333,334), with the whole 3-shard plan call on device
              tensors (3 shard launches, the merge), its host enqueue
              time and a `torch.profiler` trace of it (device time by
              kernel, device operations per call, the card's busy
              share), and the single-device kernel on the same inputs.
              K1 again at the e-commerce plan's 50,000 x 32, W = 2,048
              (phase timing_ecommerce), buckets 1/8/64.
  9. train_parity
              ALS training on 4,000 users x 3,000 items with 200,000
              planted ratings: the port's user half-steps (`ops.als.
              half_step`), explicit and implicit, at rank 10 (batched
              Cholesky) and rank 64 (CG in f32, 128 steps), against a
              float64 per-row np.linalg.solve at rtol=atol=2e-3; then a
              default 10-iteration bf16 training at rank 64 whose RMSE
              must lie within 1e-2 of the oracle's from the same init,
              with a solver residual below 1e-2.
 10. train    the MovieLens-25M shape (bench.py's generator: 162,541 x
              59,047, 25,000,000 ratings, 0.4% held out) trained at rank
              64, 10 iterations, lambda 0.05, bf16, through
              `CoreWorkflow.run_train` (what `cli train` runs) into a MEM
              store, from an engine whose data source hands out the
              generated columns (no import of over an hour). Gates: the
              instance COMPLETED with its blob stored; on the model read
              back from the store, held-out RMSE below 1.0, solver
              residual below 1e-2, zero factors on unrated rows. Prints
              the phase timings (blob bytes and store seconds among
              them), peak device bytes, padded entries and slabs, the
              port's `iteration_flops`, the per-iteration bound
              max(bytes / HBM rate, Gram flops / bf16 tensor-core rate +
              other flops / fp32 rate), where the bytes are the
              iteration's inputs read once and its outputs written once
              (the gathered opposite rows come from a table the L2
              holds), and the loop's anatomy on the slabs of the run's
              own packing: per-iteration CUDA-event and host-enqueue ms,
              eager (as training runs it) and as a CUDA graph, each with
              a `torch.profiler` pass (device time by op, operations per
              iteration, busy share), and CG's batched matvec timed as
              p^T A (the port's) and as A p. Then `fold_in_rows` for 512
              users of the training ratings against the trained item
              factors (CUDA-event and host ms, the slabs it gathers),
              held against the float64 oracle at rtol=atol=2e-3.
 11. serve_trained
              that instance deployed through `cli.main.deploy_instance`
              (`CoreWorkflow.prepare_deploy(engine, instance, ctx)`):
              /queries.json requests over its 59,047 items, checked as
              phase 4 checks them; K1's launches must equal plan calls.
 12. lifecycle
              PredictionIO's lifecycle at MovieLens-1M's shape (6,040 x
              3,706, 1,000,209 planted ratings, 0.4% held out) through
              `python -m predictionio_tpu_torch.cli` subprocesses over
              one sqlite store in a temporary directory: app new, import
              of the ratings as API-JSON rate events, build, train (rank
              64, 10 iterations, lambda 0.05), deploy, 320 HTTP
              requests. Gates: the instance COMPLETED, held-out RMSE
              below 1.0, every answer right against the plain version on
              the factors read back from the store, K1 launches equal to
              plan calls and to the warmed buckets plus one per drained
              batch chunk, on the server's `GET /`. Prints import events/s,
              the read split into scan and build, pack, transfer, solve,
              the blob's bytes and store seconds, the deploy's load,
              place and warm seconds, and the serve summary.
 13. streaming
              the same shape and split over SQLITE metadata and PEVLOG
              events (the scan on 4 spawned workers): app new, import
              (events/s beside phase 12's sqlite figure), build, train
              (one project for phases 13 and 14),
              `deploy --refresh-interval 2`, 320 requests; once GET /
              shows the refresher's baseline, a drip of rate events (64
              existing users x 3 existing items) through the port's
              PEVLOG DAO in one call and, after its fold, the requests
              again, twice (the second fold extends the first's
              history by its delta); then one deleted event and a full
              rebuild under client load. Gates: one baseline, two
              folds, nothing rolled back, failed or rebuilt before the
              delete; every answer after a fold against this process's
              own fold on the card (the template's `fold_in` between
              the watermarks around the drip); untouched users' answers
              unchanged on untouched items, bit for bit; untouched
              factor rows bit-identical; K1 launches = plan calls =
              warmed buckets + drained chunks, with no re-warm; the
              full rebuild with no failed request; the native journal
              in use. Prints each fold tick's seconds (scan, fold,
              swap, publish) and freshness_s.
 14. quickstart
              the rest of the quickstart on phase 13's store and
              instance: `cli eventserver --stats` and `deploy
              --refresh-interval 2 --feedback` in subprocesses; 320
              requests, whose `predict` events must leave the model
              alone (a `noop` tick); a drip of 192 rate events over REST
              (96 to /events.json one by one, 96 to /batch/events.json),
              folded and checked as phase 13 checks a fold; 20,000 rate
              events from 8 client processes to /batch/events.json, 50
              per request, beside 8 paced query clients (events/s and
              per-request p50/p99 beside the PEVLOG import; every
              status 201, all 20,000 found in the store and counted by
              /stats.json, a full rebuild with no failed query); a
              Segment.io webhook read back by entity and id, then
              deleted; one `predict` event per served query, none
              dropped; K1 launches = plan calls. Then `cli eval`
              (Precision@10 at threshold 4.0, 3 folds, ranks 8 and 64,
              10 iterations) on the card: the SQLITE evaluation instance
              EVALCOMPLETED with both scores, rank 8 within 1e-3 of the
              same evaluation on the CPU in this process; prints a
              popularity baseline, seconds per fold (read, train,
              predict) and the card's peak bytes. Then `cli
              batchpredict` of one query per user (6,040, num 10, half
              with a blackList): the input's order, every answer checked
              against the plain version, and the same file through
              `core.batchpredict`'s deployment in this process: the same
              lines, K1 launches = plan calls = warmed buckets + one per
              64 queries of each 1,024-query chunk; queries/s of both.

 15. templates
              the e-commerce and similar-product templates over SQLITE
              metadata and PEVLOG events (24-hour segments, 4 scan
              workers): bench.py's e-commerce scale, 5,000 users x
              50,000 items, 1,000,000 Zipf(1.3) views over 8 days, the
              first 100,000 again as buys, 1,000 unavailable items, 20
              more views for u0-u63, 1-3 of 20 categories per item and
              100,000 likes and dislikes (4:1), written through the
              port's PEVLOG DAO in process (events/s). E-commerce
              (rank 32, 5 iterations, alpha 20, lambda 0.1, 32 CG steps)
              and similar product (als, likealgo, cooccurrence at the
              template's defaults) each through `cli build`, `train`
              and `deploy`, then --templates-requests (64; two alone,
              the rest from 4 clients) and 256 queries (8 clients).
              Gates: both COMPLETED, residual
              below 1e-2; every answer against the plain version on the
              models read back (bans recomputed from the generator; the
              cooccurrence through the template's host predict, the
              three averaged); no unavailable, seen or blacklisted item
              served; K1 launches = plan calls; unknown items answer
              empty; a 3-shard `similar_plan` on the card answers as
              the single-device one. Then the streaming cooccurrence at
              bench.py's 5,000 x 20,000 x 500,000 (cap 200) on the card
              equal to the CPU's bit for bit, the dense route equal to
              the streaming one at 4,096 items; and each template's
              `fold_in` over a 192-event drip on the card against the
              CPU (factors to 2e-3, the cooccurrence merge exactly).
              Prints the train phases, the plan's banned width, p50 and
              p99, ms per store read and the queries per serve path.

`--only serve_sharded` runs the build and phase 6 alone (for a machine
with several cards), `--only train` the build and phases 9-11,
`--only lifecycle` the build and phases 3 and 12, `--only streaming`
the build and phases 3 and 13, `--only quickstart` the build, phase 3,
phase 13's import and train, and phase 14, `--only templates` the
build and phases 3 and 15; none prints the kernels line. Every run
prints its seconds (`script_s`).

Then the kernels line, the nvidia-smi line and, last,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

N_USERS = 162_541    # MovieLens-25M users
N_ITEMS = 500_000    # the large-catalog serving case
RANK = 64
K = 10               # the recommendation template's plan k
WIDTH = 64           # its banned width
TOL = 1e-5
TIMED_BUCKETS = (1, 8, 64)   # the serve run drains batches of 1-7
# the e-commerce template at bench.py's scale (bench_ecommerce_scale):
# 5,000 users, 50,000 items, 1,000,000 views, rank 32; its plan's banned
# width is _next_pow2(1,000 unavailable items + 128)
EC_USERS, EC_ITEMS, EC_VIEWS, EC_BUYS = 5_000, 50_000, 1_000_000, 100_000
EC_RANK, EC_WIDTH, EC_UNAVAILABLE = 32, 2_048, 1_000
# the lifecycle phase: GroupLens MovieLens-1M's shape
ML1M_USERS, ML1M_ITEMS, ML1M_N = 6_040, 3_706, 1_000_209
ML1M_BASE_MS = 1_577_836_800_000     # its first event time, 2020-01-01

# (HBM bytes/s, fp32 CUDA-core FLOP/s, bf16 tensor-core FLOP/s) from
# NVIDIA's data sheets, dense, at the part's full power limit; matched on
# the nvidia-smi name
PEAKS = (("H100 PCIe", 2.0e12, 51e12, 756e12),
         ("H100 NVL", 3.9e12, 60e12, 835e12),
         ("H200", 4.8e12, 67e12, 989e12), ("H100", 3.35e12, 67e12, 989e12))


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
    for key, bw, fl, bf16 in PEAKS:
        if key in name:
            return bw, fl, bf16
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


def block_edges(ft, n: int, rank: int, b: int, k: int) -> list:
    """The first and last item of every block's tile range in the
    kernel's persistent grid for these shapes (`launch_plan`)."""
    plan = ft.launch_plan(b, rank, k, n)
    tile, grid = plan["tile_items"], plan["grid"]
    n_tiles = -(-n // tile)
    share, extra = divmod(n_tiles, grid)
    edges = []
    for blk in range(grid):
        t0 = blk * share + min(blk, extra)
        t1 = t0 + share + (blk < extra)
        edges += [t0 * tile, min(t1 * tile, n) - 1]
    return edges


def ecommerce_bans(rng, b: int, n: int, edges) -> list:
    """Per-row bans as the e-commerce plan sees them: the 1,000
    unavailable ids (the even ids below 2,000) and a seen list of
    100-1,000 ids around a block edge of the kernel's grid (it straddles
    tiles), unique, in random order; at most EC_WIDTH ids."""
    rows = []
    for _ in range(b):
        m = int(rng.integers(100, 1_001))
        lo = max(0, min(n - m, int(rng.choice(edges)) - m // 2))
        ids = np.union1d(np.arange(0, 2 * EC_UNAVAILABLE, 2),
                         np.arange(lo, lo + m))[:EC_WIDTH]
        rows.append(rng.permutation(ids).tolist())
    return rows


def phase_parity(torch, ft, dev, rng) -> float:
    def run(n, rank, b, k, n_valid, bans, integer, f=None, v=None,
            width=None):
        if f is None:
            f = (rng.integers(-4, 5, (n, rank)).astype(np.float32)
                 if integer else
                 rng.standard_normal((n, rank), dtype=np.float32))
        if v is None:
            v = (rng.integers(-4, 5, (b, rank)).astype(np.float32)
                 if integer else
                 rng.standard_normal((b, rank), dtype=np.float32))
        width = width or max(WIDTH, max(len(x) for x in bans))
        ban = np.full((b, width), n, np.int32)
        for row in range(b):
            ids = bans[row % len(bans)]
            ban[row, :len(ids)] = ids
        ft_, vt, bt = (torch.from_numpy(x).to(dev) for x in (f, v, ban))
        s, i = ft.fused_topk(vt, ft_, bt, k=k, n_valid=n_valid)
        torch.cuda.synchronize()
        rs, ri = ft.fused_topk_reference(vt, ft_, bt, k=k, n_valid=n_valid)
        torch.cuda.synchronize()
        s, i, rs, ri = (x.cpu().numpy() for x in (s, i, rs, ri))
        if integer:
            if not (np.array_equal(i, ri) and np.array_equal(s, rs)):
                bad = int(np.nonzero((i != ri).any(axis=1)
                                     | (s != rs).any(axis=1))[0][0])
                fail(f"not bit-identical: n={n} rank={rank} bucket={b} "
                     f"k={k} n_valid={n_valid}; row {bad}: kernel "
                     f"{i[bad].tolist()} {s[bad].tolist()} plain "
                     f"{ri[bad].tolist()} {rs[bad].tolist()}")
            return 0.0
        return agree(s, i, rs.astype(np.float64), ri,
                     exact_scores(torch, vt, ft_, i))

    n = 20_037   # ragged last tile
    straddle = [[], list(range(120, 136)), list(range(500, 530)),
                list(range(n - 40, n)), [127, 128, 255, 256, 511, 512]]
    cases = 0
    for rank in (10, 64):
        for b in (1, 2, 8, 64, 128):
            for n_valid in (n, n - 1000, 5):
                run(n, rank, b, K, n_valid, straddle, True)
                cases += 1
    for b in (1, 8, 64):   # one 60-item tile: one block, the rest idle
        run(60, 10, b, K, 60, [list(range(60)), [], [0, 59]], True)
        cases += 1
    for b in (1, 8, 128):  # the largest k
        run(n, 64, b, 64, n, straddle, True)
        cases += 1
    # a catalog whose tile count is no multiple of the grid; bans on the
    # first and last item of every block's range, which score highest
    big = 300_007
    uneven = []
    for rank in (10, 64):
        for b in (1, 8, 64, 128):
            plan = ft.launch_plan(b, rank, K, big)
            n_tiles = -(-big // plan["tile_items"])
            uneven.append([b, rank, n_tiles, plan["grid"]])
            if n_tiles <= plan["grid"] or n_tiles % plan["grid"] == 0:
                fail(f"{big} rows make {n_tiles} tiles: not more than the "
                     f"grid {plan['grid']} and no multiple of it")
            edges = block_edges(ft, big, rank, b, K)
            f = rng.integers(-4, 5, (big, rank)).astype(np.float32)
            f[edges] = 4.0
            v = rng.integers(1, 5, (b, rank)).astype(np.float32)
            bans = [edges[:WIDTH], [], edges[-WIDTH:], edges[1::2][:WIDTH]]
            run(big, rank, b, K, big, bans, True, f=f, v=v)
            cases += 1
    # MovieLens-1M's catalog (the lifecycle phase's): fewer tiles than
    # the persistent grid could hold, so the grid shrinks to one tile per
    # block; bans on the first and last item of every block
    ml1m = []
    for rank in (10, 64):
        for b in (1, 8, 64):
            plan = ft.launch_plan(b, rank, K, ML1M_ITEMS)
            n_tiles = -(-ML1M_ITEMS // plan["tile_items"])
            ml1m.append([b, rank, n_tiles, plan["grid"]])
            if not (n_tiles < plan["sms"] * plan["blocks_per_sm"]
                    and plan["grid"] == n_tiles):
                fail(f"{ML1M_ITEMS} rows make {n_tiles} tiles on a grid of "
                     f"{plan['grid']}: not the small-catalog case")
            edges = block_edges(ft, ML1M_ITEMS, rank, b, K)
            f = rng.integers(-4, 5, (ML1M_ITEMS, rank)).astype(np.float32)
            f[edges] = 4.0
            v = rng.integers(1, 5, (b, rank)).astype(np.float32)
            run(ML1M_ITEMS, rank, b, K, ML1M_ITEMS,
                [edges[:WIDTH], [], edges[-WIDTH:], edges[1::2][:WIDTH]],
                True, f=f, v=v)
            cases += 1
    # the e-commerce plan at its catalog, rank and banned width 2,048:
    # the block edges score highest and the seen spans around them are
    # banned, so every flush tests candidates against the whole list
    ecom = []
    for b in TIMED_BUCKETS:
        edges = block_edges(ft, EC_ITEMS, EC_RANK, b, K)
        f = rng.integers(-4, 5, (EC_ITEMS, EC_RANK)).astype(np.float32)
        f[edges] = 4.0
        v = rng.integers(1, 5, (b, EC_RANK)).astype(np.float32)
        bans = ecommerce_bans(rng, b, EC_ITEMS, edges)
        run(EC_ITEMS, EC_RANK, b, K, EC_ITEMS, bans, True, f=f, v=v,
            width=EC_WIDTH)
        ecom.append([b, min(map(len, bans)), max(map(len, bans))])
        cases += 1
    # all-equal scores across block boundaries: the lowest ids win, past
    # the banned ones
    for b in (1, 8, 64):
        for k in (K, 64):
            run(big, 64, b, k, big, [[], [0, 3, 5], list(range(64))], True,
                f=np.ones((big, 64), np.float32),
                v=np.ones((b, 64), np.float32))
            cases += 1
    err = run(N_ITEMS, RANK, 64, K, N_ITEMS,
              [sorted(rng.choice(N_ITEMS, WIDTH, replace=False).tolist())],
              False)
    emit({"phase": "parity", "integer_cases": cases, "bit_identical": True,
          "uneven_grid": [dict(zip(("bucket", "rank", "tiles", "grid"), u))
                          for u in uneven],
          "small_catalog": [dict(zip(("bucket", "rank", "tiles", "grid"), u))
                            for u in ml1m],
          "ecommerce_width": {"n_items": EC_ITEMS, "rank": EC_RANK,
                              "width": EC_WIDTH,
                              "bans_per_row": [dict(zip(
                                  ("bucket", "min", "max"), e))
                                  for e in ecom]},
          "real_valued": {"n_items": N_ITEMS, "rank": RANK, "bucket": 64,
                          "max_abs_err": err, "tol": TOL}})
    return err


def make_model(torch, rng):
    """Phase 4's model: normal / sqrt(rank) factors, as bench.py's
    large-catalog serving case, on the card."""
    from predictionio_tpu_torch.ops.als import als_model_from_numpy
    t0 = time.perf_counter()
    model = als_model_from_numpy(
        rng.standard_normal((N_USERS, RANK), dtype=np.float32) / 8.0,
        rng.standard_normal((N_ITEMS, RANK), dtype=np.float32) / 8.0,
        [f"u{n}" for n in range(N_USERS)], [f"i{n}" for n in range(N_ITEMS)],
        device="cuda")
    return model, time.perf_counter() - t0


def make_queries(torch, ft, dev, rng, model, n_requests: int,
                 n_items: int = N_ITEMS):
    """The request mix over a catalog of `n_items`: num 1..K; a quarter
    of the queries ban their own top items (the bans must change the
    answer) plus random ones, a quarter a random span of up to WIDTH
    ids."""
    users = rng.integers(0, model.user_factors.shape[0], n_requests)
    nums = rng.integers(1, K + 1, n_requests)
    rows = torch.from_numpy(users).to(dev)
    none = torch.full((n_requests, 1), n_items, dtype=torch.int32,
                      device=dev)
    _, top = ft.fused_topk_reference(model.user_factors[rows],
                                     model.item_factors, none, k=K,
                                     n_valid=n_items)
    top = top.cpu().numpy()
    user_id, item_id = model.users.inverse, model.items.inverse
    queries = []
    for r in range(n_requests):
        q = {"user": user_id(int(users[r])), "num": int(nums[r])}
        if r % 4 == 1:
            extra = rng.choice(n_items, WIDTH - 5, replace=False)
            q["blackList"] = [item_id(int(x)) for x in [*top[r, :5], *extra]]
        elif r % 4 == 2:
            lo = int(rng.integers(0, n_items - WIDTH))
            q["blackList"] = [item_id(x) for x in
                              range(lo, lo + int(rng.integers(1, WIDTH)))]
        queries.append(q)
    return queries


def check_answers(torch, ft, dev, model, queries, item_scores,
                  n_items: int = N_ITEMS) -> float:
    """Every answer (a list of {"item", "score"}) against the plain
    version over the whole catalog of `n_items`; returns the max |score
    diff|."""
    from predictionio_tpu_torch.ops.topk import NEG_INF
    n = len(queries)
    rows = torch.tensor([model.users(q["user"]) for q in queries],
                        device=dev)
    banned = np.full((n, WIDTH), n_items, np.int32)
    for r, q in enumerate(queries):
        ids = [model.items(x) for x in q.get("blackList", ())]
        banned[r, :len(ids)] = ids
    bad = 0
    max_err = 0.0
    for lo in range(0, n, 64):
        sl = slice(lo, lo + 64)
        rs, ri = ft.fused_topk_reference(
            model.user_factors[rows[sl]], model.item_factors,
            torch.from_numpy(banned[sl]).to(dev), k=K, n_valid=n_items)
        rs, ri = rs.double().cpu().numpy(), ri.cpu().numpy()
        for j, r in enumerate(range(lo, min(lo + 64, n))):
            got = item_scores[r]
            keep = [c for c in range(K) if rs[j, c] > NEG_INF / 2][
                :queries[r]["num"]]
            if len(got) != len(keep):
                bad += 1
                continue
            ks = np.array([[g["score"] for g in got]])
            ki = np.array([[model.items(g["item"]) for g in got]])
            exact = exact_scores(torch, model.user_factors[rows[r:r + 1]],
                                 model.item_factors, ki)
            max_err = max(max_err, agree(ks, ki, rs[j:j + 1, :len(got)],
                                         ri[j:j + 1, :len(got)], exact))
    if bad:
        fail(f"{bad} of {n} answers have the wrong length")
    return max_err


def device_bytes(torch) -> int:
    """Bytes allocated by this process on every card."""
    return sum(torch.cuda.memory_allocated(d)
               for d in range(torch.cuda.device_count()))


def run_server(torch, ft, model, queries, mesh=None, midway=None,
               start=None) -> dict:
    """Deploy `model` (over `mesh`; or whatever `start()` deploys and
    returns the server of), send `queries` from 64 client threads, stop
    the server; the kernel counts are set to 0 just before the deploy
    and read just after the last answer. With `midway`, the queries go
    in two halves and `midway(server)` runs between them."""
    from predictionio_tpu_torch.cli.main import deploy
    from predictionio_tpu_torch.models.recommendation import Query

    if start is None:
        def start():
            return deploy(model, port=0, batch_max=64, mesh=mesh)
    before_bytes = device_bytes(torch)
    ft.LAUNCHES = 0          # the counts cover this path only
    ft.SHARD_LAUNCHES = 0
    t0 = time.perf_counter()
    server = start()
    warm_s = time.perf_counter() - t0
    added_bytes = device_bytes(torch) - before_bytes
    plan = server.deployment.algos[0]._serve_plan
    pager = server._pager
    pager_thread = pager._thread if pager is not None else None
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

    halves = [queries] if midway is None else [
        queries[:len(queries) // 2], queries[len(queries) // 2:]]
    answers, wall_s, mid = [], 0.0, None
    try:
        with ThreadPoolExecutor(64) as pool:
            for h, part in enumerate(halves):
                if h:
                    mid = midway(server)
                t0 = time.perf_counter()
                answers += list(pool.map(post, part))
                wall_s += time.perf_counter() - t0
        pager_alive = pager_thread is not None and pager_thread.is_alive()
        launches, shard_launches = ft.LAUNCHES, ft.SHARD_LAUNCHES
        plan_calls = plan.calls
        sizes = server.batcher.batch_sizes()
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/",
                                    timeout=60) as resp:
            status = json.loads(resp.read())
    finally:
        server.stop()
        server.deployment.predict_batch = predict
    if pager_thread is not None and (server._pager is not None
                                     or pager_thread.is_alive()):
        fail("stop() left the page thread running")
    # the same scoring call without the HTTP threads around it: 50
    # sequential batches of 5 queries
    batch = [Query(**q) for q in queries[:5]]
    predict(batch)
    t0 = time.perf_counter()
    for _ in range(50):
        predict(batch)
    alone_ms = 1e3 * (time.perf_counter() - t0) / 50
    if sum(n * c for n, c in sizes.items()) != len(queries):
        fail(f"batches {sizes} do not add up to {len(queries)} requests")
    expected = len(plan.buckets) + sum(
        c * -(-n // plan.max_bucket) for n, c in sizes.items())
    lat = np.sort([t for _, t in answers])
    return {"plan": plan, "model": server.deployment.models[0],
            "answers": [b["itemScores"] for b, _ in answers],
            "expected_calls": expected, "launches": launches,
            "shard_launches": shard_launches, "plan_calls": plan_calls,
            "sizes": sizes, "status": status, "warm_s": warm_s,
            "wall_s": wall_s, "batch_s": batch_s, "alone_ms": alone_ms,
            "lat": lat, "added_bytes": added_bytes, "midway": mid,
            "pager_alive": pager_alive}


def serve_summary(run: dict, n_requests: int, max_err: float) -> dict:
    sizes, batch_s, lat = run["sizes"], run["batch_s"], run["lat"]
    plan = run["plan"]
    return {"users": N_USERS, "items": N_ITEMS, "rank": RANK,
            "requests": n_requests, "answers_checked": n_requests,
            "max_abs_err": max_err,
            "batch_sizes": {str(n): c for n, c in sorted(sizes.items())},
            "drained_batches": sum(sizes.values()),
            "warmed_buckets": list(plan.buckets),
            "launches": run["launches"],
            "shard_launches": run["shard_launches"],
            "plan_calls": run["plan_calls"],
            "status_kernel_launches": run["status"]["kernel_launches"],
            "deploy_warm_s": run["warm_s"],
            "device_bytes_added_by_deploy": run["added_bytes"],
            "wall_s": run["wall_s"],
            "predict_batch_s": {"sum": sum(batch_s),
                                "mean": sum(batch_s) / len(batch_s)},
            "predict_batch_alone_ms": run["alone_ms"],
            "qps": n_requests / run["wall_s"],
            "latency_ms": {"p50": 1e3 * lat[len(lat) // 2],
                           "p99": 1e3 * lat[int(0.99 * (len(lat) - 1))]}}


def phase_serve(torch, ft, dev, rng, model, setup_s: float,
                n_requests: int) -> dict:
    """Requests in two halves; between them a new 500,000 x 64 table
    goes into the live K1 plan by `swap_factors` (the refresher's
    commit), timed from a device tensor (what a fold hands it) and from
    host RAM. The second half's answers are checked against the new
    table, the first half's against the model's."""
    queries = make_queries(torch, ft, dev, rng, model, n_requests)
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))
    new = torch.randn(N_ITEMS, RANK, device=dev, generator=gen) / 8.0
    new_host = new.cpu().numpy()

    def swap(server):
        plan = server.deployment.algos[0]._serve_plan
        out = {}
        for name, table in (("host", new_host), ("device", new)):
            ms = []
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                prev = plan.swap_factors(table)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t))
                plan.swap_factors(prev)
            out[f"{name}_ms"] = ms
        plan.swap_factors(new)
        if plan.factors.data_ptr() != new.data_ptr():
            fail("swap_factors copied a device table of the right shape")
        return out

    run = run_server(torch, ft, model, queries, midway=swap)
    launches, plan_calls = run["launches"], run["plan_calls"]
    if not (launches == plan_calls == run["expected_calls"]):
        fail(f"kernel launches {launches}, plan calls {plan_calls}, "
             f"expected {run['expected_calls']} (warmup + drained batch "
             "chunks)")
    half = len(queries) // 2
    swapped = model.__class__(model.user_factors, new, model.users,
                              model.items)
    max_err = max(
        check_answers(torch, ft, dev, model, queries[:half],
                      run["answers"][:half]),
        check_answers(torch, ft, dev, swapped, queries[half:],
                      run["answers"][half:]))
    out = {"phase": "serve", **serve_summary(run, n_requests, max_err),
           "model_setup_s": setup_s,
           "swap": {"items": N_ITEMS, "rank": RANK, **run["midway"]}}
    emit(out)
    return out


def phase_parity_sharded(torch, ft, dev, rng, model) -> float:
    from predictionio_tpu_torch.ops.topk_sharded import (
        ServeMesh, ShardedBucketedTopK)
    from predictionio_tpu_torch.parallel.mesh import shard_put

    def k2(fac, vecs, ban, n_valid, id_base=0):
        vt, bt = torch.from_numpy(vecs).to(dev), torch.from_numpy(ban).to(dev)
        s, i = ft.shard_local_candidates(vt, fac, bt, k=K, n_valid=n_valid,
                                         id_base=id_base)
        torch.cuda.synchronize()
        rs, ri = ft.fused_topk_reference(vt, fac, bt, k=K, n_valid=n_valid,
                                         id_base=id_base)
        torch.cuda.synchronize()
        if not (torch.equal(i, ri) and torch.equal(s, rs)):
            fail(f"K2 not bit-identical: per_shard={fac.shape[0]} "
                 f"bucket={vecs.shape[0]} n_valid={n_valid} "
                 f"id_base={id_base}")
        return s, i

    n = 20_037
    host = rng.integers(-4, 5, (n, RANK)).astype(np.float32)
    cases = 0
    for n_shards in (3, 4):
        shards = shard_put(host, [dev] * n_shards)
        per = shards[0].shape[0]
        # local bans: none, spans over tile edges, the shard's end,
        # single ids on both sides of edges; the filler `per` pads
        local = [[], list(range(120, 136)), list(range(250, 262)),
                 list(range(per - 40, per)), [127, 128, 255, 256, 511, 512]]
        for idx in (0, n_shards - 1):
            own = min(max(n - idx * per, 0), per)
            for n_valid in sorted({per, per - 1, 5, 0, own}):
                for b in (1, 8, 64):
                    vecs = rng.integers(-4, 5, (b, RANK)).astype(np.float32)
                    ban = np.full((b, WIDTH), per, np.int32)
                    for row in range(b):
                        ids = local[row % len(local)]
                        ban[row, :len(ids)] = ids
                    k2(shards[idx], vecs, ban, n_valid)
                    cases += 1
    # K2 as the plan launches it: GLOBAL bans straddling every shard
    # edge, the filler n and other shards' ids, with the shard's base;
    # the same answer as local bans without a base, ids offset
    base_cases = 0
    for n_shards in (3, 4):
        shards = shard_put(host, [dev] * n_shards)
        per = shards[0].shape[0]
        edges = [e for s in range(1, n_shards)
                 for e in range(s * per - 3, s * per + 3)]
        glob = [[], edges, [0, per - 1, per, n - 1],
                list(range(per - 20, per + 20)), edges[::-1]]
        for idx in range(n_shards):
            base = idx * per
            own = min(max(n - base, 0), per)
            for b in (1, 8, 64):
                vecs = rng.integers(-4, 5, (b, RANK)).astype(np.float32)
                ban = np.full((b, WIDTH), n, np.int32)
                loc = np.full((b, WIDTH), per, np.int32)
                for row in range(b):
                    ids = glob[row % len(glob)]
                    ban[row, :len(ids)] = ids
                    mine = [g - base for g in ids if 0 <= g - base < per]
                    loc[row, :len(mine)] = mine
                s, i = k2(shards[idx], vecs, ban, own, id_base=base)
                ls, li = k2(shards[idx], vecs, loc, own)
                if not (torch.equal(s, ls) and torch.equal(i, li + base)):
                    fail(f"K2 with global bans and id_base {base} differs "
                         "from local bans with ids offset")
                base_cases += 1
    # an all-banned row: 150 rows split 3 ways (per_shard 50 <= WIDTH)
    small = rng.integers(-4, 5, (150, 10)).astype(np.float32)
    for fac in shard_put(small, [dev] * 3):
        ban = np.full((2, WIDTH), 50, np.int32)
        ban[0, :50] = np.arange(50)
        k2(fac, rng.integers(-4, 5, (2, 10)).astype(np.float32), ban, 50)
        cases += 1

    # the whole plan at 3 shards on one card, integer factors with six
    # equal items straddling each shard edge
    mesh = ServeMesh((dev,) * 3, forced=True)
    f = rng.integers(-2, 3, (n, RANK)).astype(np.float32)
    per = -(-n // 3)
    for e in (per, 2 * per):
        f[e - 3:e + 3] = f[e - 3]
    plan = ShardedBucketedTopK(f, k=K, buckets=(1, 8, 64),
                               banned_width=WIDTH, mesh=mesh)
    plan.warm()
    full = torch.from_numpy(f).to(dev)
    bans_cycle = [[], [per - 2, per + 1], list(range(2 * per - 40,
                                                     2 * per + 20)),
                  [0, n - 1], [per - 3, 2 * per + 2]]
    plan_cases = 0
    for b in (1, 5, 64):
        vecs = rng.integers(-2, 3, (b, RANK)).astype(np.float32)
        vecs[0] = f[per - 3]                    # the tie group on top
        if b > 1:
            vecs[1] = f[2 * per - 3]
        bans = [bans_cycle[r % len(bans_cycle)] for r in range(b)]
        s, i = plan(vecs, bans)
        ban = np.full((b, WIDTH), n, np.int32)
        for row, bl in enumerate(bans):
            ban[row, :len(bl)] = bl
        rs, ri = ft.fused_topk_reference(
            torch.from_numpy(vecs).to(dev), full,
            torch.from_numpy(ban).to(dev), k=K, n_valid=n)
        if not (np.array_equal(i, ri.cpu().numpy())
                and np.array_equal(s, rs.cpu().numpy())):
            fail(f"sharded plan not bit-identical to the plain version "
                 f"over the whole catalog at bucket {b}")
        plan_cases += 1

    # the whole plan on the real-valued 500,000 x 64 catalog
    plan = ShardedBucketedTopK(model.item_factors, k=K, buckets=(64,),
                               banned_width=WIDTH, mesh=mesh)
    plan.warm()
    if (plan.per_shard, plan.n_pad) != (-(-N_ITEMS // 3),
                                        3 * -(-N_ITEMS // 3)):
        fail(f"per_shard {plan.per_shard}, padded rows {plan.n_pad}")
    rows = torch.from_numpy(rng.integers(0, N_USERS, 64)).to(dev)
    vecs = model.user_factors[rows]
    ban = np.stack([rng.choice(N_ITEMS, WIDTH, replace=False)
                    for _ in range(64)]).astype(np.int32)
    ban[:8, :8] = np.arange(2 * plan.per_shard - 4, 2 * plan.per_shard + 4)
    s, i = plan(vecs, [r.tolist() for r in ban])
    bt = torch.from_numpy(ban).to(dev)
    rs, ri = ft.fused_topk_reference(vecs, model.item_factors, bt, k=K,
                                     n_valid=N_ITEMS)
    err = agree(s, i, rs.double().cpu().numpy(), ri.cpu().numpy(),
                exact_scores(torch, vecs, model.item_factors, i))
    ks, ki = ft.fused_topk(vecs.contiguous(), model.item_factors, bt, k=K,
                           n_valid=N_ITEMS)
    same_as_k1 = bool(np.array_equal(i, ki.cpu().numpy())
                      and np.array_equal(s, ks.cpu().numpy()))
    if not same_as_k1:
        fail("sharded plan differs from the single-device kernel on the "
             "real-valued catalog (the per-item FMA order is the same)")
    emit({"phase": "parity_sharded", "k2_integer_cases": cases,
          "k2_global_ban_cases": base_cases,
          "plan_integer_cases": plan_cases, "bit_identical": True,
          "real_valued": {"n_items": N_ITEMS, "rank": RANK, "bucket": 64,
                          "n_shards": 3, "per_shard": plan.per_shard,
                          "max_abs_err": err, "tol": TOL,
                          "bit_identical_to_single_device": same_as_k1}})
    return err


def phase_serve_sharded(torch, ft, dev, rng, model,
                        n_requests: int) -> dict:
    from predictionio_tpu_torch.ops.als import ALSModel
    from predictionio_tpu_torch.ops.topk_sharded import (
        ServeMesh, ShardedBucketedTopK)
    queries = make_queries(torch, ft, dev, rng, model, n_requests)
    meshes = [("one_card", ServeMesh((dev,) * 3, forced=True))]
    count = torch.cuda.device_count()
    if count >= 2:
        meshes.append(("one_shard_per_card", ServeMesh(
            tuple(torch.device("cuda", c) for c in range(min(count, 3))),
            forced=True)))
    out = {}
    for name, mesh in meshes:
        # a model object of its own over the same tensors: the sharded
        # plan takes the device state and the deploy moves this model's
        # item master to host RAM
        smodel = ALSModel(model.user_factors, model.item_factors,
                          model.users, model.items)
        run = run_server(torch, ft, smodel, queries, mesh=mesh)
        if smodel.item_factors.device.type != "cpu":
            fail(f"{name}: the deployed model's item master stayed on "
                 f"{smodel.item_factors.device} beside the shards")
        plan = run["plan"]
        if not isinstance(plan, ShardedBucketedTopK) \
                or plan.n_shards != mesh.n_shards:
            fail(f"{name}: deploy built {type(plan).__name__}, not a "
                 f"{mesh.n_shards}-shard plan")
        calls, want = run["plan_calls"], run["expected_calls"]
        if not (calls == want and run["shard_launches"] == run["launches"]
                == plan.n_shards * calls):
            fail(f"{name}: K2 launches {run['shard_launches']}, kernel "
                 f"launches {run['launches']}, plan calls {calls}, expected "
                 f"{plan.n_shards} x {want} (warmup + drained batch chunks)")
        max_err = check_answers(torch, ft, dev, model, queries,
                                run["answers"])
        row = {"phase": "serve_sharded", "mesh": name,
               "devices": [str(d) for d in plan.devices],
               "n_shards": plan.n_shards, "per_shard": plan.per_shard,
               "padding_rows": plan.n_pad - N_ITEMS,
               "item_master": str(smodel.item_factors.device),
               **serve_summary(run, n_requests, max_err)}
        emit(row)
        out[name] = row
    return out["one_card"]


def phase_serve_tiered(torch, ft, dev, rng, model, n_queries: int) -> dict:
    import os
    from predictionio_tpu_torch.ops.als import ALSModel
    from predictionio_tpu_torch.ops.topk_tiered import TieredTopK

    hot = N_ITEMS // 4
    queries = make_queries(torch, ft, dev, rng, model, n_queries)
    for r in range(0, n_queries, 4):     # bans on both sides of the slab
        queries[r]["blackList"] = [f"i{x}" for x in range(hot - 10,
                                                           hot + 10)]
    # the item master in host RAM, as `items_device="cpu"` loads it: the
    # plan pins only the hot slab on the card
    tmodel = ALSModel(model.user_factors, model.item_factors.cpu(),
                      model.users, model.items)

    def midway(server):
        """One page pass (fold + rebalance) through the server's pager:
        it must swap the slab without launching or warming anything."""
        plan = server.deployment.algos[0]._serve_plan
        before = (ft.LAUNCHES, plan.calls, set(plan._hot._warm))
        gids = plan.slot_gids
        t0 = time.perf_counter()
        promoted = server._pager.tick()
        page = {"promoted": promoted, "seconds": time.perf_counter() - t0}
        if promoted <= 0 or np.array_equal(gids, plan.slot_gids):
            fail("rebalance promoted nothing")
        if (ft.LAUNCHES, plan.calls, set(plan._hot._warm)) != before:
            fail("rebalance launched or warmed the kernel")
        return page

    # the pager's own ticks are an hour apart: the one rebalance of the
    # run is `midway`'s
    knobs = {"PIO_SERVE_TIER": "on", "PIO_TIER_HOT_FRAC": "0.25",
             "PIO_TIER_PAGE_INTERVAL_S": "3600"}
    saved = {v: os.environ.get(v) for v in knobs}
    os.environ.update(knobs)
    try:
        run = run_server(torch, ft, tmodel, queries, midway=midway)
    finally:
        for v, val in saved.items():
            if val is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = val
    plan = run["plan"]
    if not isinstance(plan, TieredTopK) or plan.hot_items != hot:
        fail(f"deploy built {type(plan).__name__}, not a {hot}-item "
             "tiered plan")
    if run["status"]["plans"] != ["TieredTopK"] or not run["pager_alive"]:
        fail(f"GET / shows plans {run['status']['plans']}, page thread "
             f"alive {run['pager_alive']}")
    catalog = N_ITEMS * RANK * 4
    if run["added_bytes"] >= catalog // 2:
        fail(f"the tiered deploy added {run['added_bytes']} bytes on the "
             f"card, not just its {hot * RANK * 4}-byte slab")
    calls, want = run["plan_calls"], run["expected_calls"]
    if not (run["launches"] == calls == want) or run["shard_launches"]:
        fail(f"tiered: kernel launches {run['launches']}, hot-slab calls "
             f"{calls}, expected {want} (warmup + drained batch chunks)")
    max_err = check_answers(torch, ft, dev, model, queries, run["answers"])
    out = {"phase": "serve_tiered", "hot_items": plan.hot_items,
           "slab_bytes": hot * RANK * 4, "item_master": "cpu",
           "rebalance": run["midway"], "hit_ratio": plan.hit_ratio(),
           "pager_thread_alive_while_serving": run["pager_alive"],
           **serve_summary(run, n_queries, max_err)}
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
    bw, fl, _ = peaks(card)
    factors = torch.from_numpy(
        rng.standard_normal((N_ITEMS, RANK), dtype=np.float32)).to(dev)
    out = {}
    for b in TIMED_BUCKETS:
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


def phase_timing_ecommerce(torch, ft, dev, rng, card: str) -> dict:
    """K1 at the e-commerce plan's shape (50,000 x 32, k = 10, W =
    2,048, real-valued factors) per timed bucket, beside its plain
    version, the library chain and the bound, as `phase_timing`."""
    from predictionio_tpu_torch.ops.topk import NEG_INF
    bw, fl, _ = peaks(card)
    factors = torch.from_numpy(rng.standard_normal(
        (EC_ITEMS, EC_RANK), dtype=np.float32)).to(dev)
    out = {}
    for b in TIMED_BUCKETS:
        vecs = torch.from_numpy(
            rng.standard_normal((b, EC_RANK), dtype=np.float32)).to(dev)
        rows = ecommerce_bans(rng, b, EC_ITEMS,
                              block_edges(ft, EC_ITEMS, EC_RANK, b, K))
        ban = np.full((b, EC_WIDTH), EC_ITEMS, np.int32)
        for r, ids in enumerate(rows):
            ban[r, :len(ids)] = ids
        banned = torch.from_numpy(ban).to(dev)
        # the library chain repeats a row's first ban in its padding
        banned64 = torch.where(banned < EC_ITEMS, banned,
                               banned[:, :1]).long()

        def library():
            s = torch.matmul(vecs, factors.T)
            s.scatter_(1, banned64, NEG_INF)
            return torch.topk(s, K)

        kernel_ms = time_ms(torch, lambda: ft.fused_topk(
            vecs, factors, banned, k=K, n_valid=EC_ITEMS), 50)
        plain_ms = time_ms(torch, lambda: ft.fused_topk_reference(
            vecs, factors, banned, k=K, n_valid=EC_ITEMS), 20)
        library_ms = time_ms(torch, library, 20)
        nbytes = (4 * (EC_ITEMS * EC_RANK + b * EC_RANK + b * EC_WIDTH)
                  + 8 * b * K)
        flops = 2 * b * EC_ITEMS * EC_RANK
        t_bytes, t_ops = nbytes / bw, flops / fl
        row = {"bucket": b, "width": EC_WIDTH, "ms": kernel_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_us": 1e6 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "flops": flops,
               "bans_per_row": [len(r) for r in rows][:8]}
        emit({"phase": "timing_ecommerce", "card": card, **row})
        out[b] = row
    return out


def phase_timing_sharded(torch, ft, dev, rng, model, card: str) -> dict:
    from predictionio_tpu_torch.ops.topk import NEG_INF
    from predictionio_tpu_torch.ops.topk_sharded import (
        ServeMesh, ShardedBucketedTopK)
    bw, fl, _ = peaks(card)
    plan = ShardedBucketedTopK(model.item_factors, k=K, buckets=(1, 64),
                               banned_width=WIDTH,
                               mesh=ServeMesh((dev,) * 3, forced=True))
    plan.warm()
    per, fac = plan.per_shard, plan.factors[-1]
    n_valid = N_ITEMS - 2 * per               # the last shard's own
    kk = plan.k_shard
    out = {}
    for b in (1, 64):
        vecs = torch.from_numpy(
            rng.standard_normal((b, RANK), dtype=np.float32)).to(dev)
        base = N_ITEMS - n_valid                  # 2 * per
        # global bans on this shard's rows: the library chain takes them
        # as local ids
        local = torch.from_numpy(np.stack(
            [rng.choice(n_valid, WIDTH, replace=False) for _ in range(b)]
        ).astype(np.int32)).to(dev)
        local64 = local.long()
        glob = local + base

        def library():
            s = torch.matmul(vecs, fac.T)
            s.scatter_(1, local64, NEG_INF)
            s[:, n_valid:] = NEG_INF
            return torch.topk(s, kk)

        kernel_ms = time_ms(torch, lambda: ft.shard_local_candidates(
            vecs, fac, glob, k=kk, n_valid=n_valid, id_base=base), 50)
        plain_ms = time_ms(torch, lambda: ft.fused_topk_reference(
            vecs, fac, glob, k=kk, n_valid=n_valid, id_base=base), 20)
        library_ms = time_ms(torch, library, 20)
        plan_ms = time_ms(torch, lambda: plan._launch(vecs, glob), 50)
        # the host's enqueue time for the same calls: when it matches
        # plan_ms, the card waits on the host between launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            plan._launch(vecs, glob)
        host_ms = 1e3 * (time.perf_counter() - t0) / 50
        torch.cuda.synchronize()
        single_ms = time_ms(torch, lambda: ft.fused_topk(
            vecs, model.item_factors, glob, k=K, n_valid=N_ITEMS), 50)
        nbytes = 4 * (per * RANK + b * RANK + b * WIDTH) + 8 * b * kk
        flops = 2 * b * per * RANK
        t_bytes, t_ops = nbytes / bw, flops / fl
        row = {"bucket": b, "per_shard": per, "n_valid": n_valid,
               "ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "flops": flops,
               "plan_call_ms": plan_ms, "plan_call_host_ms": host_ms,
               "n_shards": plan.n_shards,
               "single_device_kernel_ms": single_ms}
        row["profile"] = profile_calls(
            torch, lambda: plan._launch(vecs, glob), 20)
        emit({"phase": "timing_sharded", "card": card, **row})
        out[b] = row
    return out


def profile_calls(torch, fn, iters: int, top: int = 12) -> dict:
    """Device time per call by kernel name under `torch.profiler`, the
    device operations (kernels, copies, memsets) per call, and the
    device's busy share of the wall time (the profiler's own host
    cost inflates the wall time, so the share is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / iters
    from torch.autograd import DeviceType
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue     # host ops carry their kernels' time as well
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            kernels.append({"name": ev.key[:80], "ms": us / 1e3 / iters,
                            "count": ev.count / iters})
    kernels.sort(key=lambda r: -r["ms"])
    device_ms = sum(r["ms"] for r in kernels)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms if wall_ms else None,
            "kernels_per_call": sum(r["count"] for r in kernels),
            "kernels": kernels[:top]}


# the training phases: MovieLens-25M's shape (bench.py:315-333)
ML25M_USERS, ML25M_ITEMS, ML25M_N = 162_541, 59_047, 25_000_000
TRAIN_RANK, TRAIN_ITERS, TRAIN_REG = 64, 10, 0.05
HELD_OUT = 0.004
TRAIN_TOL = 2e-3     # half-step parity against the float64 oracle


def planted(n_users: int, n_items: int, n: int, seed: int):
    """bench.py's `synthetic_ml25m` at any size: uniform users,
    Zipf(0.5) item popularity, planted rank-8 structure quantized to
    1-5 stars."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, n, dtype=np.int64).astype(np.int32)
    pop = np.arange(1, n_items + 1, dtype=np.float64) ** -0.5
    cdf = np.cumsum(pop / pop.sum())
    i = np.searchsorted(cdf, rng.random(n)).astype(np.int32)
    np.clip(i, 0, n_items - 1, out=i)
    xu = rng.standard_normal((n_users, 8), np.float32)
    yi = rng.standard_normal((n_items, 8), np.float32)
    r = np.empty(n, np.float32)
    for s in range(0, n, 5_000_000):   # chunked: bounds host RAM
        e = min(s + 5_000_000, n)
        raw = (xu[u[s:e]] * yi[i[s:e]]).sum(1) / 2.8 + 3.0
        r[s:e] = np.clip(np.round(raw), 1, 5)
    return u, i, r


def oracle_half_step(y, row_ix, col_ix, val, n_rows: int, reg: float,
                     implicit: bool = False, alpha: float = 1.0):
    """One half-step in float64 by per-row normal equations and
    np.linalg.solve (ALS-WR; implicit: Hu-Koren-Volinsky on positive
    ratings). Rows without ratings stay zero."""
    y = np.asarray(y, np.float64)
    rank = y.shape[1]
    order = np.argsort(row_ix, kind="stable")
    c, v = col_ix[order], val[order].astype(np.float64)
    bounds = np.searchsorted(row_ix[order], np.arange(n_rows + 1))
    yty = y.T @ y if implicit else np.zeros((rank, rank))
    live = np.nonzero(np.diff(bounds))[0]
    a = np.empty((len(live), rank, rank))
    b = np.empty((len(live), rank))
    for j, row in enumerate(live):
        lo, hi = bounds[row], bounds[row + 1]
        yu = y[c[lo:hi]]
        w = alpha * v[lo:hi] if implicit else np.ones(hi - lo)
        a[j] = yty + (yu * w[:, None]).T @ yu + reg * (hi - lo) * np.eye(rank)
        b[j] = yu.T @ ((1.0 + w) if implicit else v[lo:hi])
    x = np.zeros((n_rows, rank))
    x[live] = np.linalg.solve(a, b[..., None])[..., 0]
    return x


def phase_train_parity(torch, dev, seed: int) -> dict:
    """The port's user half-steps (exact Cholesky at rank 10, CG at rank
    64 in f32 with 128 iterations, explicit and implicit) against the
    float64 oracle, and a default bf16 training against the oracle's
    training from the same init."""
    from predictionio_tpu_torch.ops import als
    n_users, n_items, n = 4_000, 3_000, 200_000
    u, i, r = planted(n_users, n_items, n, seed + 2)
    rng = np.random.default_rng(seed + 3)
    half_steps = []
    for rank in (10, TRAIN_RANK):
        side = als._pack_side(u, i, r, n_users, rank)
        slabs = als.device_slabs(side, torch.float32, dev)
        y = np.abs(rng.standard_normal((n_items, rank))) / np.sqrt(rank)
        x0 = np.abs(rng.standard_normal((n_users, rank))) / np.sqrt(rank)
        for implicit in (False, True):
            alpha = 2.0 if implicit else 1.0
            t0 = time.perf_counter()
            x, res = als.half_step(
                torch.tensor(x0, dtype=torch.float32, device=dev),
                torch.tensor(y, dtype=torch.float32, device=dev), slabs,
                TRAIN_REG, alpha, implicit=implicit, cg_iters=128)
            torch.cuda.synchronize()
            port_s = time.perf_counter() - t0
            want = oracle_half_step(y.astype(np.float32), u, i, r, n_users,
                                    TRAIN_REG, implicit, alpha)
            got = x.cpu().numpy().astype(np.float64)
            excess = np.abs(got - want) - (TRAIN_TOL + TRAIN_TOL * np.abs(want))
            if excess.max() > 0:
                fail(f"half-step rank {rank} implicit {implicit}: "
                     f"max |diff| {np.abs(got - want).max()} past rtol=atol="
                     f"{TRAIN_TOL}")
            half_steps.append({"rank": rank, "implicit": implicit,
                               "slabs": len(slabs),
                               "max_abs_err": float(np.abs(got - want).max()),
                               "solver_residual": res, "port_s": port_s})
    # the default training (bf16 gather, 8 CG steps) against the oracle
    tm = {}
    x, y = als.als_train((u, i, r), n_users, n_items, rank=TRAIN_RANK,
                         iterations=TRAIN_ITERS, reg=TRAIN_REG, seed=seed,
                         timings=tm, device=dev)
    _, y0 = als.init_factors(n_users, n_items, TRAIN_RANK, seed,
                             np.bincount(u, minlength=n_users) > 0,
                             np.bincount(i, minlength=n_items) > 0)
    yo = y0.astype(np.float64)
    t0 = time.perf_counter()
    for _ in range(TRAIN_ITERS):
        xo = oracle_half_step(yo, u, i, r, n_users, TRAIN_REG)
        yo = oracle_half_step(xo, i, u, r, n_items, TRAIN_REG)
    oracle_s = time.perf_counter() - t0
    port_rmse = als.rmse(x, y, u, i, r)
    pred = np.einsum("nr,nr->n", xo[u], yo[i])
    oracle_rmse = float(np.sqrt(np.mean((pred - r) ** 2)))
    if not abs(port_rmse - oracle_rmse) < 1e-2:
        fail(f"bf16 training RMSE {port_rmse} vs oracle {oracle_rmse}")
    if not tm["solver_residual"] < 1e-2:
        fail(f"bf16 training solver residual {tm['solver_residual']}")
    out = {"phase": "train_parity", "users": n_users, "items": n_items,
           "ratings": n, "tol": TRAIN_TOL, "half_steps": half_steps,
           "training": {"rank": TRAIN_RANK, "iterations": TRAIN_ITERS,
                        "precision": "bf16", "rmse": port_rmse,
                        "oracle_rmse": oracle_rmse, "oracle_s": oracle_s,
                        "timings": tm}}
    emit(out)
    return out


def generated_engine(cols):
    """The recommendation template with its data source swapped for one
    that hands out `cols`, the way a user's engine plugs in its own
    source: the ML-25M shape's 25 M generated ratings skip a store
    import of over an hour, while training, persistence and the
    instance lifecycle run as `cli train` runs them."""
    from predictionio_tpu_torch.core.base import (DataSource, FirstServing,
                                                  IdentityPreparator)
    from predictionio_tpu_torch.core.engine import Engine
    from predictionio_tpu_torch.models.recommendation import ALSAlgorithm

    class GeneratedRatings(DataSource):
        def read_training(self, ctx):
            return cols

    return Engine(GeneratedRatings, IdentityPreparator,
                  {"als": ALSAlgorithm}, FirstServing)


FOLD_USERS = 512   # PIO_FOLD_MAX_TOUCHED's default


def fold_timing(torch, dev, model, cols, seed: int) -> dict:
    """`ops.als.fold_in_rows` on the card for FOLD_USERS users of the
    training ratings against the trained item factors (CG from zero at
    rank 64), held against the float64 oracle at rtol=atol=TRAIN_TOL:
    CUDA-event ms and host ms (the host packing and transfer included),
    and the degree-bucketed slabs it gathers."""
    from predictionio_tpu_torch.ops import als
    rng = np.random.default_rng(seed + 9)
    users = rng.choice(np.unique(cols.user_ix), FOLD_USERS, replace=False)
    order = np.argsort(cols.user_ix, kind="stable")
    bounds = np.searchsorted(cols.user_ix[order], users)
    ends = np.searchsorted(cols.user_ix[order], users, side="right")
    hist = [(cols.item_ix[order[a:b]], cols.rating[order[a:b]])
            for a, b in zip(bounds, ends)]
    y = model.item_factors

    def fold():
        return als.fold_in_rows(y, hist, reg=TRAIN_REG, device=dev)

    got = fold()                           # warm: cuBLAS handles, caches
    ms = time_ms(torch, fold, 3)
    host_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fold()
        torch.cuda.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t))
    lens = np.array([len(h[0]) for h in hist])
    row_ix = np.repeat(np.arange(FOLD_USERS), lens)
    col_ix = np.concatenate([h[0] for h in hist])
    val = np.concatenate([h[1] for h in hist])
    want = oracle_half_step(y.cpu().numpy(), row_ix, col_ix, val,
                            FOLD_USERS, TRAIN_REG)
    err = np.abs(got.cpu().numpy().astype(np.float64) - want)
    if (err - (TRAIN_TOL + TRAIN_TOL * np.abs(want))).max() > 0:
        fail(f"fold_in_rows vs the float64 oracle: max |diff| {err.max()} "
             f"past rtol=atol={TRAIN_TOL}")
    side = als._pack_side(row_ix.astype(np.int32), col_ix.astype(np.int32),
                          val, FOLD_USERS)
    slabs = [(int((rows != als._FILL_ROW).sum()), cap)
             for rows, cap in zip(side.rows, side.caps)]
    padded = sum(len(rows) * cap for rows, cap in zip(side.rows, side.caps))
    return {"users": FOLD_USERS, "ratings": int(lens.sum()),
            "longest_history": int(lens.max()), "ms": ms,
            "host_ms": host_ms, "max_abs_err": float(err.max()),
            "tol": TRAIN_TOL, "slabs": len(slabs),
            "largest_slab": max(slabs, key=lambda x: x[0] * x[1]),
            "padded_entries": padded,
            "gather_bytes": padded * y.shape[1] * 4,
            "one_padded_slab_bytes": FOLD_USERS * int(
                1 << (int(lens.max()) - 1).bit_length()) * y.shape[1] * 4}


def phase_train(torch, dev, card: str, seed: int):
    """The ML-25M shape trained through `CoreWorkflow.run_train` (what
    `cli train` runs) into a MEM store: the instance must be COMPLETED
    with its model blob stored; the model read back from the store is
    gated on held-out RMSE, the solver residual and zero factors on
    unrated rows. Then the loop again on the slabs of that run's own
    packing for its anatomy: per-iteration CUDA-event ms and host
    enqueue ms, as the training runs it (eagerly) and captured as a
    CUDA graph, and a `torch.profiler` pass over one iteration of each.
    Returns the phase's line, the engine, the instance, its registry and
    the model read back."""
    from predictionio_tpu_torch.core.persistence import deserialize_models
    from predictionio_tpu_torch.core.runtime import RuntimeContext
    from predictionio_tpu_torch.core.workflow import CoreWorkflow
    from predictionio_tpu_torch.data.storage import (EngineInstanceStatus,
                                                     StorageRegistry)
    from predictionio_tpu_torch.ingest.arrays import RatingColumns
    from predictionio_tpu_torch.ingest.bimap import BiMap
    from predictionio_tpu_torch.ops import als, linalg

    t0 = time.perf_counter()
    u, i, r = planted(ML25M_USERS, ML25M_ITEMS, ML25M_N, seed)
    test = np.random.default_rng(seed + 1).random(ML25M_N) < HELD_OUT
    keep = ~test
    cols = RatingColumns(u[keep], i[keep], r[keep],
                         np.zeros(int(keep.sum()), np.int64),
                         BiMap.from_keys(f"u{n}" for n in range(ML25M_USERS)),
                         BiMap.from_keys(f"i{n}" for n in range(ML25M_ITEMS)))
    data_s = time.perf_counter() - t0
    engine = generated_engine(cols)
    params = engine.engine_params_from_variant(
        {"algorithms": [{"name": "als", "params": {
            "rank": TRAIN_RANK, "num_iterations": TRAIN_ITERS,
            "lambda_": TRAIN_REG, "seed": seed}}]})
    registry = StorageRegistry({"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM"})
    ctx = RuntimeContext(registry=registry, device=dev)
    # the anatomy below reuses this run's packing: keep the two sides
    # the trainer packs
    sides = []
    pack_side = als._pack_side

    def recording(*a, **kw):
        sides.append(pack_side(*a, **kw))
        return sides[-1]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base_bytes = torch.cuda.memory_allocated(dev)
    als._pack_side = recording
    t0 = time.perf_counter()
    try:
        instance = CoreWorkflow.run_train(engine, params, ctx,
                                          engine_variant="ml25m")
    finally:
        als._pack_side = pack_side
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base_bytes
    tm = dict(ctx.phase_timings)
    if instance.status != EngineInstanceStatus.COMPLETED:
        fail(f"the training instance is {instance.status}")
    t0 = time.perf_counter()
    model, = deserialize_models(
        registry.get_model_data_models().get(instance.id).models,
        instance.id, [None], ctx, retrain=None)
    model = model.to(dev)
    load_s = time.perf_counter() - t0
    heldout = als.rmse(model.user_factors, model.item_factors, u[test],
                       i[test], r[test])
    if not heldout < 1.0:
        fail(f"held-out RMSE {heldout} is not below 1.0")
    if not tm["solver_residual"] < 1e-2:
        fail(f"solver residual {tm['solver_residual']} is not below 1e-2")
    unrated = []
    for f, ix, n_rows in ((model.user_factors, cols.user_ix, ML25M_USERS),
                          (model.item_factors, cols.item_ix, ML25M_ITEMS)):
        absent = torch.from_numpy(np.bincount(ix, minlength=n_rows) == 0)
        rows = f[absent.to(dev)]
        if rows.numel() and bool(rows.abs().max() > 0):
            fail("a row without ratings has nonzero factors")
        unrated.append(int(absent.sum()))

    fold = fold_timing(torch, dev, model, cols, seed)

    # the same loop again, on the trained factors, for its anatomy
    if len(sides) != 2:
        fail(f"the training packed {len(sides)} sides, not 2")
    packed = als.PackedRatings(sides[0], sides[1], ML25M_USERS, ML25M_ITEMS,
                               TRAIN_RANK)
    val_dt = (torch.bfloat16 if als._bf16_exact(packed.user_side.val)
              else torch.float32)
    slabs = [als.device_slabs(packed.user_side, val_dt, dev),
             als.device_slabs(packed.item_side, val_dt, dev)]
    it = als._Iteration(model.user_factors.clone(),
                        model.item_factors.clone(), slabs[0], slabs[1],
                        TRAIN_REG, 1.0, implicit=False, rank=TRAIN_RANK,
                        cast=torch.bfloat16)

    def enqueue_ms(fn, n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            out.append(1e3 * (time.perf_counter() - t))
        torch.cuda.synchronize()
        return out

    eager_ms = time_ms(torch, it, 3)
    eager_enqueue = enqueue_ms(it, 3)
    eager_prof = profile_calls(torch, it, 1, top=15)
    # the iteration as a CUDA graph, to see what the host's enqueue costs
    # the loop; the first iteration on the capture stream sets up the
    # libraries' per-stream state
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        it()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        it()
    graph_ms = time_ms(torch, graph.replay, 5)
    graph_enqueue = enqueue_ms(graph.replay, 3)
    graph_prof = profile_calls(torch, graph.replay, 3, top=15)

    # CG's matvec in both orientations on the user side's normal
    # matrices (one CG batch): the port computes p^T A
    n_mv = sum(len(rows) for rows in packed.user_side.rows)
    a_mv = torch.randn(n_mv, TRAIN_RANK, TRAIN_RANK, device=dev)
    p_mv = torch.randn(n_mv, TRAIN_RANK, device=dev)
    matvec = {"rows": n_mv,
              "pT_A_ms": time_ms(torch, lambda: linalg._matvec(a_mv, p_mv), 5),
              "A_p_ms": time_ms(torch, lambda: torch.bmm(a_mv, p_mv[..., None]),
                                5)}
    del a_mv, p_mv

    # the bound: each input of an iteration read once (index and value
    # columns, slab row ids, both factor tables) and each output written
    # once (both tables). The gathered opposite rows are not counted:
    # they come from a table of 7.5 MB (items) or 20.8 MB (users) in
    # bf16, which the card's 50 MB L2 holds
    bw, fl, bf16 = peaks(card)
    pad = als.padded_entries(packed)
    gram = sum(2 * len(rows) * k * TRAIN_RANK ** 2
               for side_ in (packed.user_side, packed.item_side)
               for rows, k in zip(side_.rows, side_.caps))
    flops = als.iteration_flops(packed)
    val_bytes = 2 if val_dt == torch.bfloat16 else 4
    slab_rows = sum(len(rows) for side_ in (packed.user_side,
                                            packed.item_side)
                    for rows in side_.rows)
    nbytes = (pad * (4 + val_bytes) + slab_rows * 4
              + 2 * (ML25M_USERS + ML25M_ITEMS) * TRAIN_RANK * 4)
    t_bytes, t_ops = nbytes / bw, gram / bf16 + (flops - gram) / fl
    out = {"phase": "train", "card": card, "users": ML25M_USERS,
           "items": ML25M_ITEMS, "ratings": ML25M_N,
           "train_ratings": cols.n, "held_out": int(test.sum()),
           "rank": TRAIN_RANK, "iterations": TRAIN_ITERS, "reg": TRAIN_REG,
           "precision": "bf16", "value_dtype": str(val_dt),
           "data_s": data_s, "train_s": train_s, "timings": tm,
           "heldout_rmse": heldout, "unrated_rows": unrated,
           "peak_device_bytes": peak,
           "slabs": [len(packed.user_side.rows), len(packed.item_side.rows)],
           "padded_entries": pad, "iteration_flops": flops,
           "gram_flops": gram, "bytes": nbytes,
           "bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "instance": {"status": instance.status,
                        "blob_bytes": tm["blob_bytes"],
                        "store_s": tm["store_s"], "load_s": load_s},
           "matvec": matvec,
           "eager": {"iteration_ms": eager_ms, "enqueue_ms": eager_enqueue,
                     "profile": eager_prof},
           "graph": {"iteration_ms": graph_ms, "enqueue_ms": graph_enqueue,
                     "profile": graph_prof},
           "fold_in": fold}
    emit(out)
    return out, engine, instance, registry, model


def phase_serve_trained(torch, ft, dev, rng, trained,
                        n_requests: int) -> dict:
    """The instance `run_train` recorded, deployed through
    `cli.main.deploy_instance` (`CoreWorkflow.prepare_deploy(engine,
    instance, ctx)`: the blob read back from the store onto the card):
    /queries.json requests through K1, checked against the plain
    version on the model phase train read back."""
    from predictionio_tpu_torch.cli.main import deploy_instance
    from predictionio_tpu_torch.core.runtime import RuntimeContext
    _, engine, instance, registry, model = trained
    ctx = RuntimeContext(registry=registry, device=dev)
    n_items = model.item_factors.shape[0]
    queries = make_queries(torch, ft, dev, rng, model, n_requests, n_items)
    run = run_server(torch, ft, None, queries, start=lambda: deploy_instance(
        engine, instance, ctx, port=0, batch_max=64))
    launches, plan_calls = run["launches"], run["plan_calls"]
    if not (launches == plan_calls == run["expected_calls"]):
        fail(f"trained model: kernel launches {launches}, plan calls "
             f"{plan_calls}, expected {run['expected_calls']}")
    served = run["model"]
    if run["status"]["engineInstanceId"] != instance.id or not (
            torch.equal(served.user_factors, model.user_factors)
            and torch.equal(served.item_factors, model.item_factors)):
        fail("the deploy served another model than the instance's")
    max_err = check_answers(torch, ft, dev, model, queries, run["answers"],
                            n_items)
    out = {"phase": "serve_trained", "engine_instance": instance.id,
           "deploy_timings": run["status"]["deploy_timings"],
           **serve_summary(run, n_requests, max_err),
           "users": model.user_factors.shape[0], "items": n_items,
           "rank": model.user_factors.shape[1]}
    emit(out)
    return out


def write_ml1m_project(tmp: Path, u, i, r, test, seed: int) -> float:
    """The lifecycle's inputs in `tmp`: the training ratings as API-JSON
    `rate` events (distinct event times, one millisecond apart, from
    2020-01-01) and the engine.json (rank 64, 10 iterations, lambda
    0.05); returns the seconds the events file took."""
    t0 = time.perf_counter()
    ul, il, rl = u.tolist(), i.tolist(), r.tolist()
    with open(tmp / "events.jsonl", "w") as f:
        for n in np.nonzero(~test)[0].tolist():
            f.write('{"event":"rate","entityType":"user","entityId":'
                    f'"u{ul[n]}","targetEntityType":"item",'
                    f'"targetEntityId":"i{il[n]}","properties":'
                    f'{{"rating":{rl[n]}}},"eventTime":{ML1M_BASE_MS + n}}}'
                    '\n')
    (tmp / "engine.json").write_text(json.dumps({
        "id": "ml1m", "engineFactory": "recommendation",
        "datasource": {"params": {"app_name": "ml1m"}},
        "algorithms": [{"name": "als", "params": {
            "rank": TRAIN_RANK, "num_iterations": TRAIN_ITERS,
            "lambda_": TRAIN_REG, "seed": seed}}]}))
    return time.perf_counter() - t0


def cli_runner(tmp: Path, config: dict, **env_extra):
    """`cli(*args)` runs `python -m predictionio_tpu_torch.cli *args` in
    `tmp` over the store `config`, fails the smoke on a non-zero exit,
    and returns (its JSON output, wall seconds)."""
    import os
    repo = str(Path(__file__).resolve().parent)
    env = {**os.environ, **config, **env_extra, "PYTHONPATH": repo}

    def cli(*args):
        t = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "predictionio_tpu_torch.cli", *args],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            fail(f"cli {' '.join(args)} exited {out.returncode}: "
                 f"{out.stderr[-3000:]}")
        return json.loads(out.stdout), time.perf_counter() - t

    cli.env = env
    return cli


def http_post(port: int, q):
    """POST one query; (body, seconds)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(q).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    t = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as resp:
        body = json.loads(resp.read())
    return body, time.perf_counter() - t


def serve_http(port: int, queries, clients: int = 64) -> list:
    """`queries` from `clients` threads; [(body, seconds)] in order."""
    with ThreadPoolExecutor(clients) as pool:
        return list(pool.map(lambda q: http_post(port, q), queries))


def http_status(port: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                timeout=60) as resp:
        return json.loads(resp.read())


def read_models(config: dict, iid: str, dev):
    """Every model of instance `iid` as the store holds it, read back
    through the port's registry and `deserialize_models`, on `dev` where
    the model moves; returns (models, the instance's row)."""
    from predictionio_tpu_torch.core.persistence import deserialize_models
    from predictionio_tpu_torch.data.storage import (EngineInstanceStatus,
                                                     StorageRegistry)
    registry = StorageRegistry(config)
    row = registry.get_meta_data_engine_instances().get(iid)
    if row is None or row.status != EngineInstanceStatus.COMPLETED:
        fail(f"the store holds instance {iid} as "
             f"{row.status if row else 'missing'}")
    n = len(json.loads(row.algorithms_params))
    models = deserialize_models(
        registry.get_model_data_models().get(iid).models, iid, [None] * n,
        None, retrain=None)
    registry.close()
    return [m.to(dev) if callable(getattr(m, "to", None)) else m
            for m in models], row


def read_model(config: dict, iid: str, dev):
    """The model of single-algorithm instance `iid` as the store holds
    it, on `dev` (`read_models`)."""
    (model,), row = read_models(config, iid, dev)
    return model, row


def heldout_rmse(model, u, i, r, test) -> float:
    from predictionio_tpu_torch.ops import als
    uu = [model.users.get(f"u{x}") for x in u[test]]
    ii = [model.items.get(f"i{x}") for x in i[test]]
    seen = np.array([a is not None and b is not None
                     for a, b in zip(uu, ii)])
    return als.rmse(
        model.user_factors, model.item_factors,
        np.array([a for a, s_ in zip(uu, seen) if s_]),
        np.array([b for b, s_ in zip(ii, seen) if s_]), r[test][seen])


def start_server(tmp: Path, cli, command: str, *args):
    """`cli <command> *args` in the background, its stderr into a file
    of `tmp` (a pipe that nobody reads would block the server once it
    filled); returns the process and the first line it printed."""
    log = tmp / f"{command}_{time.monotonic_ns()}.stderr"
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli", command,
             *args], cwd=tmp, env=cli.env, stdout=subprocess.PIPE,
            stderr=err, text=True)
    proc.stderr_log = log
    return proc, proc.stdout.readline()


def stderr_tail(proc) -> str:
    return proc.stderr_log.read_text()[-3000:]


def start_deploy(tmp: Path, cli, iid: str, *extra):
    """`cli deploy --port 0 --batch-max 64 *extra` in the background;
    returns (process, port, seconds until it serves)."""
    t0 = time.perf_counter()
    proc, line = start_server(tmp, cli, "deploy", "--port", "0",
                              "--batch-max", "64", *extra)
    if not line.startswith(f"serving engine instance {iid} on "):
        proc.kill()
        fail(f"deploy did not come up: {line!r} {stderr_tail(proc)}")
    port = int(line.split("http://127.0.0.1:")[1].split()[0])
    return proc, port, time.perf_counter() - t0


def stop_deploy(proc, what: str = "deploy") -> None:
    """SIGTERM a server process (`what`: the deploy or the event
    server); it must exit 0."""
    import signal
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        code = proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        code = proc.wait()
    if code != 0:
        fail(f"the {what} process exited {code}: {stderr_tail(proc)}")


def launch_gate(what: str, status: dict, n_requests: int,
                straddle: int = 0) -> dict:
    """K1's launches on the server's `GET /` must equal its plan calls
    and the warmed buckets plus one per drained batch chunk. A drained
    batch whose requests took two deployments (a publish while they
    queued) is two plan calls: `straddle` allows up to that many."""
    launches = status["kernel_launches"]["fused_topk"]
    sizes = {int(k): v for k, v in status["batch_sizes"].items()}
    if sum(n * c for n, c in sizes.items()) != n_requests:
        fail(f"{what}: batches {sizes} do not add up to {n_requests} "
             "requests")
    buckets, = status["plan_buckets"]
    expected = len(buckets) + sum(c * -(-n // max(buckets))
                                  for n, c in sizes.items())
    if not (launches == status["plan_calls"]
            and expected <= launches <= expected + straddle):
        fail(f"{what}: K1 launches {launches}, plan calls "
             f"{status['plan_calls']}, expected {expected} (warmup + "
             f"drained batch chunks, + up to {straddle} straddling a "
             "publish)")
    return {"launches": launches, "plan_calls": status["plan_calls"],
            "expected_calls": expected, "warmed_buckets": buckets,
            "batch_sizes": status["batch_sizes"],
            "drained_batches": sum(sizes.values())}


def latency_ms(answers) -> dict:
    lat = np.sort([t for _, t in answers])
    return {"p50": 1e3 * lat[len(lat) // 2],
            "p99": 1e3 * lat[int(0.99 * (len(lat) - 1))]}


def phase_lifecycle(torch, ft, dev, rng, seed: int, n_requests: int) -> dict:
    """PredictionIO's lifecycle at MovieLens-1M's shape, through the
    port's command line in subprocesses over one sqlite store in a
    temporary directory: `app new`, `import` of the ratings as API-JSON
    `rate` events (0.4% held out, not imported), `build`, `train` (rank
    64, 10 iterations, lambda 0.05), `deploy`, then `n_requests` HTTP
    requests to /queries.json. Gates: the instance is COMPLETED, the
    held-out RMSE is below 1.0, every answer checks against the plain
    version on the factors read back from the model store (the port's
    registry and `deserialize_models`), and the server's `GET /` shows
    K1's launches equal to its plan calls (the deploy process counts
    from 0)."""
    from predictionio_tpu_torch.data.storage import EngineInstanceStatus

    u, i, r = planted(ML1M_USERS, ML1M_ITEMS, ML1M_N, seed + 5)
    test = np.random.default_rng(seed + 6).random(ML1M_N) < HELD_OUT
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lifecycle_") as tmp:
        tmp = Path(tmp)
        config = {"PIO_STORAGE_SOURCES_PIO_TYPE": "SQLITE",
                  "PIO_STORAGE_SOURCES_PIO_PATH": str(tmp / "pio.db")}
        write_s = write_ml1m_project(tmp, u, i, r, test, seed)
        cli = cli_runner(tmp, config)
        app, _ = cli("app", "new", "ml1m")
        imported, import_wall_s = cli("import", "--appid", str(app["id"]),
                                      "--input", "events.jsonl")
        n_train = int((~test).sum())
        if imported["imported"] != n_train:
            fail(f"imported {imported['imported']} of {n_train} events")
        cli("build")
        report, train_wall_s = cli("train")
        if report["status"] != EngineInstanceStatus.COMPLETED:
            fail(f"the lifecycle instance is {report['status']}")
        iid = report["engineInstanceId"]
        model, _ = read_model(config, iid, dev)
        heldout = heldout_rmse(model, u, i, r, test)
        if not heldout < 1.0:
            fail(f"lifecycle held-out RMSE {heldout} is not below 1.0")
        n_items = model.item_factors.shape[0]
        queries = make_queries(torch, ft, dev, rng, model, n_requests,
                               n_items)
        proc, port, deploy_wall_s = start_deploy(tmp, cli, iid)
        try:
            t0 = time.perf_counter()
            answers = serve_http(port, queries)
            wall_s = time.perf_counter() - t0
            status = http_status(port)
        finally:
            stop_deploy(proc)
    if status["engineInstanceId"] != iid or status["plans"] != [
            "BucketedTopK"]:
        fail(f"GET / shows instance {status['engineInstanceId']}, plans "
             f"{status['plans']}")
    gate = launch_gate("lifecycle", status, n_requests)
    max_err = check_answers(torch, ft, dev, model, queries,
                            [b["itemScores"] for b, _ in answers], n_items)
    tm = report["phaseTimings"]
    out = {"phase": "lifecycle", "users": len(model.users),
           "items": n_items, "events": n_train,
           "held_out": int(test.sum()), "rank": TRAIN_RANK,
           "iterations": TRAIN_ITERS, "reg": TRAIN_REG,
           "engine_instance": iid, "status": report["status"],
           "heldout_rmse": heldout, "events_file_s": write_s,
           "import": {"seconds": imported["seconds"],
                      "events_per_s": n_train / imported["seconds"],
                      "command_wall_s": import_wall_s},
           "train": {"command_wall_s": train_wall_s,
                     "read_s": tm["read_s"], "scan_s": tm["ingest_scan_s"],
                     "build_s": tm["ingest_build_s"],
                     "pack_s": tm["pack_s"], "transfer_s": tm["transfer_s"],
                     "solve_s": tm["solve_s"],
                     "solver_residual": tm["solver_residual"],
                     "blob_bytes": tm["blob_bytes"],
                     "store_s": tm["store_s"]},
           "deploy": {"command_to_serving_s": deploy_wall_s,
                      **status["deploy_timings"]},
           "serve": {"requests": n_requests, "answers_checked": n_requests,
                     "max_abs_err": max_err, **gate,
                     "wall_s": wall_s, "qps": n_requests / wall_s,
                     "latency_ms": latency_ms(answers)}}
    emit(out)
    return out


STREAM_INTERVAL_S = 2.0     # the deploy's --refresh-interval
DRIP_USERS, DRIP_PER_USER = 64, 3
HAMMER_CLIENTS = 8          # client threads during the full rebuild


def wait_status(port: int, proc, what: str, ok, timeout_s: float) -> dict:
    """Poll the server's `GET /` until `ok(status)`; fail after
    `timeout_s` or when the deploy process died."""
    t_end = time.perf_counter() + timeout_s
    while True:
        status = http_status(port)
        if ok(status):
            return status
        if proc.poll() is not None or time.perf_counter() > t_end:
            fail(f"{what}: not reached in {timeout_s} s; refresher "
                 f"{status.get('refresh')}")
        time.sleep(0.05)


def drip_events(model, rng, now_s: float):
    """DRIP_USERS existing users rating DRIP_PER_USER existing items
    each, stamped within the last second before `now_s`, all in one day
    (one PEVLOG segment, so one append covers them)."""
    from predictionio_tpu_torch.data.event import DataMap, Event
    from datetime import datetime, timezone
    users = rng.choice(len(model.users), DRIP_USERS, replace=False)
    n = DRIP_USERS * DRIP_PER_USER
    end_us = int(now_s * 1e6)
    day_us = 86_400 * 10**6
    if (end_us - n * 1000) // day_us != end_us // day_us:
        end_us = (end_us // day_us) * day_us + n * 1000
    out = []
    for k, ux in enumerate(users.tolist()):
        for j, ix in enumerate(rng.choice(len(model.items), DRIP_PER_USER,
                                          replace=False).tolist()):
            t_us = end_us - (n - (k * DRIP_PER_USER + j)) * 1000
            out.append(Event(
                "rate", "user", model.users.inverse(ux), "item",
                model.items.inverse(ix),
                DataMap({"rating": float(rng.integers(1, 6))}),
                datetime.fromtimestamp(t_us / 1e6, tz=timezone.utc)))
    return out


class Hammer:
    """HAMMER_CLIENTS client threads that post `queries` in turn for as
    long as the `with` block lasts, each pausing `pause_s` after every
    request, recording each request's seconds and every failure."""

    def __init__(self, port: int, queries, pause_s: float = 0.0):
        self.port, self.queries, self.pause_s = port, queries, pause_s
        self.seconds, self.failures = [], []
        self._stop = False
        self._pool = ThreadPoolExecutor(HAMMER_CLIENTS)
        self._futs = []

    def _client(self, n: int) -> None:
        while not self._stop:
            q = self.queries[n % len(self.queries)]
            n += HAMMER_CLIENTS
            try:
                self.seconds.append(http_post(self.port, q)[1])
            except Exception as e:  # noqa: BLE001 — counted, reported
                self.failures.append(repr(e))
            time.sleep(self.pause_s)

    def __enter__(self):
        self._futs = [self._pool.submit(self._client, n)
                      for n in range(HAMMER_CLIENTS)]
        return self

    def __exit__(self, *exc):
        self._stop = True
        for f in self._futs:
            f.result()
        self._pool.shutdown()

    def summary(self) -> dict:
        return {"requests": len(self.seconds),
                "failed_requests": len(self.failures),
                "latency_ms": latency_ms([(None, t) for t in self.seconds])}


def pevlog_project(tmp: Path, dev, seed: int) -> dict:
    """The lifecycle's generator and held-out split over SQLITE metadata
    and PEVLOG events in `tmp` (the scan on 4 spawned workers), through
    the command line: `app new`, `import`, `build`, `train`. Gates: the
    native journal in use, every event imported, the instance COMPLETED,
    held-out RMSE below 1.0. Returns what phases streaming and
    quickstart share: the store's config, the `cli` runner, the app, the
    instance and its model read back on `dev`."""
    from predictionio_tpu_torch.data.storage import EngineInstanceStatus
    from predictionio_tpu_torch.native.eventlog import EventLog

    u, i, r = planted(ML1M_USERS, ML1M_ITEMS, ML1M_N, seed + 5)
    test = np.random.default_rng(seed + 6).random(ML1M_N) < HELD_OUT
    n_train = int((~test).sum())
    config = {"PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
              "PIO_STORAGE_SOURCES_DB_PATH": str(tmp / "pio.db"),
              "PIO_STORAGE_SOURCES_PEV_TYPE": "PEVLOG",
              "PIO_STORAGE_SOURCES_PEV_PATH": str(tmp / "pevlog"),
              "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
              "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "PEV",
              "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB"}
    write_s = write_ml1m_project(tmp, u, i, r, test, seed)
    cli = cli_runner(tmp, config, PIO_INGEST_WORKERS="4")
    uses_native = EventLog(str(tmp / "probe.log")).uses_native
    if not uses_native:
        fail("the event journal is not the native (g++) build")
    app, _ = cli("app", "new", "ml1m")
    imported, import_wall_s = cli("import", "--appid", str(app["id"]),
                                  "--input", "events.jsonl")
    if imported["imported"] != n_train:
        fail(f"imported {imported['imported']} of {n_train} events")
    cli("build")
    report, train_wall_s = cli("train")
    if report["status"] != EngineInstanceStatus.COMPLETED:
        fail(f"the PEVLOG instance is {report['status']}")
    iid = report["engineInstanceId"]
    model, row = read_model(config, iid, dev)
    heldout = heldout_rmse(model, u, i, r, test)
    if not heldout < 1.0:
        fail(f"PEVLOG held-out RMSE {heldout} is not below 1.0")
    return {"tmp": tmp, "config": config, "cli": cli, "app": app,
            "app_id": app["id"], "iid": iid, "model": model, "row": row,
            "report": report, "n_train": n_train, "heldout": heldout,
            "uses_native": uses_native, "write_s": write_s, "seed": seed,
            "imported": imported, "import_wall_s": import_wall_s,
            "train_wall_s": train_wall_s}


def fold_gates(torch, ft, dev, queries, before, folded, touched_users,
               touched_items, prev_answers, answers, n_items):
    """What a fold served must show: it ran on the card; untouched
    factor rows bit-identical; every answer right against `folded`
    (this process's own fold); an untouched user's answers on untouched
    items the same scores, bit for bit, in the same order (touched items
    may enter or leave). Returns (max abs err, untouched users'
    answers, of them identical)."""
    if folded.user_factors.device != dev:
        fail(f"the fold ran on {folded.user_factors.device}, not the card")
    touched_u = {folded.users.get(x) for x in touched_users}
    touched_i = {folded.items.get(x) for x in touched_items}
    keep_u = torch.tensor([x for x in range(len(before.users))
                           if x not in touched_u], device=dev)
    keep_i = torch.tensor([x for x in range(n_items)
                           if x not in touched_i], device=dev)
    if not (torch.equal(folded.user_factors[keep_u],
                        before.user_factors[keep_u])
            and torch.equal(folded.item_factors[keep_i],
                            before.item_factors[keep_i])):
        fail("a fold changed untouched factor rows")
    items = [b["itemScores"] for b, _ in answers]
    max_err = check_answers(torch, ft, dev, folded, queries, items, n_items)
    untouched = unchanged = 0
    touched_names, users = set(touched_items), set(touched_users)
    for q, (b1, _), a2 in zip(queries, prev_answers, items):
        if q["user"] in users:
            continue
        untouched += 1
        s1 = [(x["item"], x["score"]) for x in b1["itemScores"]
              if x["item"] not in touched_names]
        s2 = [(x["item"], x["score"]) for x in a2
              if x["item"] not in touched_names]
        m = min(len(s1), len(s2))
        if s1[:m] != s2[:m]:
            fail(f"untouched user {q['user']}: {s1} before, {s2} after")
        unchanged += b1["itemScores"] == a2
    return max_err, untouched, unchanged


def phase_streaming(torch, ft, dev, rng, project: dict, n_requests: int,
                    sqlite_events_per_s=None) -> dict:
    """Streaming fold-in at MovieLens-1M's shape over `pevlog_project`'s
    store: `deploy --refresh-interval 2`, requests;
    once `GET /` shows the refresher's `baseline`, a drip batch of rate
    events (64 existing users x 3 existing items) goes in through the
    port's PEVLOG DAO in one call and, after its fold, the requests
    again; twice, so that the second fold extends the first one's
    history; then one event is deleted and the next tick must rebuild
    in full while clients keep hammering. Gates: one baseline, two folds
    and no rolled_back, failed or full_rebuild before the delete; every
    answer after a fold against this process's own fold on the card
    (the template's `fold_in` on the instance's model, then on its first
    fold, between the watermarks before and after each drip);
    untouched users' answers bit-identical on untouched items and
    untouched factor rows bit-identical; K1 launches = plan calls =
    warmed buckets + drained chunks with the warmed buckets unchanged
    (no re-warm); a `full_rebuild` with no failed request."""
    from predictionio_tpu_torch.core.workflow import (
        engine_params_from_instance)
    from predictionio_tpu_torch.data.storage import StorageRegistry
    from predictionio_tpu_torch.models.recommendation import (
        RecommendationEngine)
    from predictionio_tpu_torch.streaming import scan_delta
    from predictionio_tpu_torch.streaming.updaters import FoldContext

    tmp, config, cli = project["tmp"], project["config"], project["cli"]
    app_id, iid, model = project["app_id"], project["iid"], project["model"]
    n_train, report = project["n_train"], project["report"]
    n_items = model.item_factors.shape[0]
    queries = make_queries(torch, ft, dev, rng, model, n_requests,
                           n_items)
    registry = StorageRegistry(config)
    events = registry.get_events()
    engine = RecommendationEngine.apply()
    _, _, (algo,), _ = engine.make_components(
        engine_params_from_instance(engine, project["row"]))

    own = [model]
    own_fold_s = []

    def own_fold(rd):
        rd["delta"] = scan_delta(events, app_id, None, rd["since"],
                                 rd["upto"])
        fctx = FoldContext(store=events, app_id=app_id, channel_id=None,
                           since=rd["since"], upto=rd["upto"],
                           ds_params={"app_name": "ml1m"})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        own.append(algo.fold_in(own[-1], rd["delta"], fctx))
        torch.cuda.synchronize()
        own_fold_s.append(time.perf_counter() - t0)

    proc, port, deploy_wall_s = start_deploy(
        tmp, cli, iid, "--refresh-interval", str(STREAM_INTERVAL_S))
    try:
        st0 = wait_status(port, proc, "the refresher's baseline",
                          lambda s: s["refresh"]["ticks"].get(
                              "baseline"), 120)
        answers0 = serve_http(port, queries)
        # the same client load with nothing else happening, as the
        # reference for the latency during the second fold and the
        # rebuild
        with Hammer(port, queries) as quiet:
            time.sleep(2 * STREAM_INTERVAL_S)
        # two drips, each one insert_batch (one append, one watermark
        # step); the second fold extends the first one's history and
        # runs under client load
        rounds, loads = [], [quiet]
        for rnd in (1, 2):
            with Hammer(port, queries) if rnd == 2 else \
                    contextlib.nullcontext() as load:
                wm_before = events.ingest_watermark(app_id)
                drip = drip_events(model, rng, time.time())
                t_drip = time.perf_counter()
                drip_ids = events.insert_batch(drip, app_id)
                wm_after = events.ingest_watermark(app_id)
                st = wait_status(
                    port, proc, f"fold {rnd}",
                    lambda s, n=rnd: s["refresh"]["ticks"].get(
                        "folded", 0) >= n, 120)
                seen_s = time.perf_counter() - t_drip
            if load is not None:
                loads.append(load)
            rounds.append({"since": wm_before, "upto": wm_after,
                           "events": len(drip), "status": st,
                           "seen_s": seen_s,
                           "answers": serve_http(port, queries),
                           "after": http_status(port)})
            # this process's own fold of the same delta, on the card,
            # before anything else lands in the store (a fold reads
            # the store's current rows)
            own_fold(rounds[-1])
        # the delete (of a drip event: its user and item keep their
        # other ratings, so no shape changes): the next tick rebuilds
        # in full while clients keep asking
        with Hammer(port, queries) as load:
            if not events.delete(drip_ids[0], app_id):
                fail("the delete found no event")
            t_del = time.perf_counter()
            st3 = wait_status(port, proc, "a full rebuild",
                              lambda s: s["refresh"]["ticks"].get(
                                  "full_rebuild"), 300)
            rebuild_seen_s = time.perf_counter() - t_del
        loads.append(load)
        answers3 = serve_http(port, queries)
        st4 = http_status(port)
    finally:
        stop_deploy(proc)

    registry.close()

    ticks1 = rounds[-1]["status"]["refresh"]["ticks"]
    if ticks1.get("baseline") != 1 or ticks1.get("folded") != 2 or any(
            ticks1.get(k) for k in ("rolled_back", "failed",
                                    "full_rebuild")):
        fail(f"refresher ticks before the delete: {ticks1}")
    prev_answers, max_err, untouched, unchanged = answers0, 0.0, 0, 0
    for rd, before, folded in zip(rounds, own, own[1:]):
        delta = rd["delta"]
        if rd["after"]["refresh"]["watermark"] != rd["upto"]:
            fail("the served model's watermark is not the drip's")
        err, n_u, n_same = fold_gates(
            torch, ft, dev, queries, before, folded, delta.touched_users,
            delta.touched_items, prev_answers, rd["answers"], n_items)
        max_err, untouched, unchanged = (max(max_err, err), untouched + n_u,
                                         unchanged + n_same)
        prev_answers = rd["answers"]
    st0_buckets = st0["plan_buckets"]
    for n, rd in enumerate(rounds, 1):
        if rd["after"]["plan_buckets"] != st0_buckets or rd["after"][
                "plans"] != ["BucketedTopK"]:
            fail(f"fold {n} re-warmed: buckets {st0_buckets} -> "
                 f"{rd['after']['plan_buckets']}")
    for load in loads:
        if load.failures:
            fail(f"{len(load.failures)} requests failed under load: "
                 f"{load.failures[:3]}")
    gate_fold = launch_gate(
        "streaming after the folds", rounds[-1]["after"],
        3 * n_requests + len(loads[0].seconds) + len(loads[1].seconds),
        straddle=HAMMER_CLIENTS)
    ticks3 = st3["refresh"]["ticks"]
    if any(ticks3.get(k) for k in ("rolled_back", "failed")):
        fail(f"refresher ticks after the delete: {ticks3}")
    gate_rebuild = launch_gate(
        "streaming after the rebuild", st4,
        4 * n_requests + sum(len(x.seconds) for x in loads),
        straddle=2 * HAMMER_CLIENTS)
    for b, _ in answers3:
        if not b["itemScores"] or not all(
                np.isfinite(x["score"]) for x in b["itemScores"]):
            fail(f"after the rebuild: answer {b}")
    tm = report["phaseTimings"]
    out = {"phase": "streaming", "users": len(model.users),
           "items": n_items, "events": n_train, "rank": TRAIN_RANK,
           "engine_instance": iid, "heldout_rmse": project["heldout"],
           "uses_native": project["uses_native"],
           "events_file_s": project["write_s"],
           "import": {"seconds": project["imported"]["seconds"],
                      "events_per_s": n_train / project["imported"][
                          "seconds"],
                      "sqlite_events_per_s": sqlite_events_per_s,
                      "command_wall_s": project["import_wall_s"]},
           "train": {"command_wall_s": project["train_wall_s"],
                     "read_s": tm["read_s"],
                     "scan_s": tm.get("ingest_scan_s"),
                     "build_s": tm.get("ingest_build_s"),
                     "solve_s": tm["solve_s"]},
           "deploy": {"command_to_serving_s": deploy_wall_s,
                      **st0["deploy_timings"]},
           "refresh_interval_s": STREAM_INTERVAL_S,
           "folds": [{"events": rd["events"],
                      "touched_users": len(rd["delta"].touched_users),
                      "touched_items": len(rd["delta"].touched_items),
                      "seen_folded_after_s": rd["seen_s"],
                      "tick_s": rd["status"]["refresh"]["last_ticks"][
                          "folded"],
                      "freshness_s": rd["status"]["refresh"]["freshness_s"],
                      "own_fold_s": s_}
                     for rd, s_ in zip(rounds, own_fold_s)],
           "answers_checked": 2 * n_requests, "max_abs_err": max_err,
           "untouched_answers": untouched,
           "untouched_answers_identical": unchanged,
           "serve_after_folds": {**gate_fold, "latency_ms": latency_ms(
               rounds[-1]["answers"])},
           "load": {"clients": HAMMER_CLIENTS,
                    "quiet": loads[0].summary(),
                    "during_second_fold": loads[1].summary(),
                    "during_rebuild": loads[2].summary()},
           "rebuild": {"seen_after_s": rebuild_seen_s,
                       "tick_s": st3["refresh"]["last_ticks"][
                           "full_rebuild"],
                       "ticks": st4["refresh"]["ticks"], **gate_rebuild},
           "launches": gate_rebuild["launches"]}
    emit(out)
    return out


INGEST_EVENTS, INGEST_BATCH, INGEST_CLIENTS = 20_000, 50, 8
# each query client's pause during phase quickstart's ingest: 8 clients
# ask at most 16 queries/s, a load whose predict events the feedback
# worker (one POST each, to an event server busy with the ingest) keeps
# up with; its queue drops what it cannot (160 queries/s overflowed it
# beside an NVIDIA H100 80GB HBM3 at 700 W)
QS_PACE_S = 0.5
EVAL_FOLDS, EVAL_RANKS = 3, (8, 64)
# Precision@10 counts an item the user rated 4 or 5 stars in the test
# fold (`planted` quantizes to 1-5 stars), as the upstream template's
# Evaluation.scala sets PrecisionAtK(k = 10, ratingThreshold = 4.0)
EVAL_K, EVAL_THRESHOLD = 10, 4.0
EVAL_TOL = 1e-3     # rank 8 on the card against the same eval on the CPU
BP_CHUNK = 1024     # cli batchpredict's --query-partitions default

# One ingest client: POSTs its batches over one kept-alive connection
# and prints, per request, [start, end, HTTP status, item statuses].
INGEST_CLIENT = """
import http.client, json, sys, time
port, key, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
out = []
for body in json.load(open(path)):
    t0 = time.time()
    conn.request("POST", "/batch/events.json?accessKey=" + key,
                 json.dumps(body).encode(),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    reply = json.loads(resp.read())
    out.append([t0, time.time(), resp.status,
                [r["status"] for r in reply]])
print(json.dumps(out))
"""

# The evaluation `cli eval` runs, written into the project as the
# upstream template's Evaluation.scala: Precision@10 over 3 folds, one
# candidate per rank, 10 iterations each.
EVAL_MODULE = """
from predictionio_tpu_torch.core.evaluation import (EngineParamsGenerator,
                                                    Evaluation)
from predictionio_tpu_torch.core.params import EngineParams
from predictionio_tpu_torch.models import recommendation as rec

DS = ("", rec.DataSourceParams(app_name="ml1m", eval_params=rec.EvalParams(
    k_fold={folds}, query_num={k})))


def candidate(rank):
    return EngineParams(data_source_params=DS, algorithm_params_list=(
        ("als", rec.ALSAlgorithmParams(rank=rank, num_iterations={iters},
                                       lambda_={reg}, seed={seed})),))


QuickstartEvaluation = Evaluation(
    engine=rec.RecommendationEngine.apply(),
    metric=rec.PrecisionAtK(k={k}, rating_threshold={threshold}))
QuickstartParams = EngineParamsGenerator([candidate(r) for r in {ranks}])
"""


class Rest:
    """A kept-alive connection to the event server, with the access key;
    a call returns (status, JSON reply). The server closes a connection
    idle for a minute: a call that finds it closed reconnects once."""

    def __init__(self, port: int, key: str):
        import http.client
        self.connect = lambda: http.client.HTTPConnection(
            "127.0.0.1", port, timeout=120)
        self.conn, self.key = self.connect(), key

    def __call__(self, method: str, path: str, body=None):
        import http.client
        sep = "&" if "?" in path else "?"
        data = None if body is None else json.dumps(body).encode()
        for attempt in (0, 1):
            try:
                self.conn.request(method, f"{path}{sep}accessKey={self.key}",
                                  data, {"Content-Type": "application/json"})
                resp = self.conn.getresponse()
                return resp.status, json.loads(resp.read())
            except (http.client.RemoteDisconnected, ConnectionError):
                self.conn.close()
                self.conn = self.connect()
                if attempt:
                    raise


def start_eventserver(tmp: Path, cli):
    """`cli eventserver --port 0 --stats` in the background; returns
    (process, port)."""
    proc, line = start_server(tmp, cli, "eventserver", "--ip", "127.0.0.1",
                              "--port", "0", "--stats")
    if not line.startswith("Event server started on 127.0.0.1:"):
        proc.kill()
        fail(f"the event server did not come up: {line!r} "
             f"{stderr_tail(proc)}")
    return proc, int(line.rsplit(":", 1)[1])


def covers(wm, target) -> bool:
    """True when watermark `wm` reaches `target` in every journal."""
    return wm is not None and all(wm.get(k, -1) >= v
                                  for k, v in target.items())


class WatermarkLog:
    """A thread that polls the server's `GET /` while the `with` block
    lasts and keeps every distinct watermark the served model reflected,
    in order (each the upper bound of a tick that moved it)."""

    def __init__(self, port: int):
        import threading
        self.port, self.seen = port, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._stop.is_set():
            wm = http_status(self.port)["refresh"]["watermark"]
            if not self.seen or self.seen[-1] != wm:
                self.seen.append(wm)
            self._stop.wait(0.02)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def ingest_batches(model, rng, t0_ms: int):
    """INGEST_EVENTS `rate` events of existing users and items, stamped
    one millisecond apart from `t0_ms`, in batches of INGEST_BATCH."""
    from predictionio_tpu_torch.data.event import format_time
    from datetime import datetime, timezone
    users = rng.integers(0, len(model.users), INGEST_EVENTS)
    items = rng.integers(0, len(model.items), INGEST_EVENTS)
    stars = rng.integers(1, 6, INGEST_EVENTS)
    evs = [{"event": "rate", "entityType": "user",
            "entityId": model.users.inverse(int(users[n])),
            "targetEntityType": "item",
            "targetEntityId": model.items.inverse(int(items[n])),
            "properties": {"rating": float(stars[n])},
            "eventTime": format_time(datetime.fromtimestamp(
                (t0_ms + n) / 1e3, tz=timezone.utc))}
           for n in range(INGEST_EVENTS)]
    return [evs[lo:lo + INGEST_BATCH]
            for lo in range(0, INGEST_EVENTS, INGEST_BATCH)]


def pevlog_insert_ms(tmp: Path, n: int = 200) -> float:
    """Milliseconds of one `EventStore.insert` of one event into a fresh
    PEVLOG directory of `tmp` (one fsync'd journal append), alone: the
    floor under every event the event server stores."""
    from predictionio_tpu_torch.data.event import DataMap, Event
    from predictionio_tpu_torch.data.storage import StorageRegistry
    registry = StorageRegistry({
        "PIO_STORAGE_SOURCES_MEM_TYPE": "MEM",
        "PIO_STORAGE_SOURCES_PEV_TYPE": "PEVLOG",
        "PIO_STORAGE_SOURCES_PEV_PATH": str(tmp / "insert_probe"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "PEV",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"})
    events = registry.get_events()
    events.init(1)
    batch = [Event("rate", "user", f"u{k}", "item", f"i{k}",
                   DataMap({"rating": 3.0})) for k in range(n)]
    t0 = time.perf_counter()
    for e in batch:
        events.insert(e, 1)
    ms = 1e3 * (time.perf_counter() - t0) / n
    registry.close()
    return ms


def popularity_precision(folds, metric) -> float:
    """The metric of recommending each fold's most rated training items
    to every test user (numpy counts)."""
    from predictionio_tpu_torch.models.recommendation import (
        ItemScore, PredictedResult)
    scores = []
    for train, _, qa in folds:
        counts = np.bincount(train.item_ix, minlength=len(train.items))
        top = np.argsort(-counts, kind="stable")[:metric.k]
        pred = PredictedResult(tuple(
            ItemScore(train.items.inverse(int(x)), float(counts[x]))
            for x in top))
        scores += [s for s in (metric.calculate_one(q, pred, a)
                               for q, a in qa) if s is not None]
    return float(np.mean(scores))


def phase_quickstart(torch, ft, dev, rng, project: dict, n_requests: int,
                     import_events_per_s=None) -> dict:
    """The rest of the quickstart over `pevlog_project`'s store, the
    trained instance deployed with `--refresh-interval 2 --feedback`
    beside `cli eventserver --stats`:

      1. requests; their `predict` events (the feedback) land in the
         store and the tick over them is `noop`; then a drip of 192
         `rate` events (64 existing users x 3 existing items, stamped
         now) over REST, half to /events.json one by one, half to
         /batch/events.json, right after a tick; the refresher folds it
         and the answers are checked against this process's own fold
         between the same watermarks;
      2. 8 client processes POST 20,000 `rate` events to
         /batch/events.json, 50 per request, while 8 paced clients
         query; the refresher rebuilds in full;
      3. a Segment.io `track` body to /webhooks/segmentio.json, read
         back by entity and by id, deleted once the deploy stopped;
      4. one `predict` event per served query, none dropped;
      5. `cli eval` of Precision@10 over 3 folds, ranks 8 and 64, on the
         card, its rank-8 score held against the same evaluation on the
         CPU in this process, beside a popularity baseline;
      6. `cli batchpredict` of one query per user (num 10, half with a
         blackList), every answer checked, the order kept, then the same
         file through `run_batch_predict`'s deployment in this process:
         K1 launches = plan calls = warmed buckets + one per 64 queries
         of each 1,024-query chunk."""
    import importlib
    from datetime import datetime, timezone
    from urllib.parse import quote
    from predictionio_tpu_torch.core.batchpredict import (load_deployment,
                                                          predict_lines)
    from predictionio_tpu_torch.core.evaluation import (_eval_with_cache,
                                                        _PrefixCache)
    from predictionio_tpu_torch.core.runtime import RuntimeContext
    from predictionio_tpu_torch.core.workflow import (
        engine_params_from_instance)
    from predictionio_tpu_torch.data.storage import (
        EvaluationInstanceStatus, StorageRegistry)
    from predictionio_tpu_torch.models.recommendation import (
        RecommendationEngine)
    from predictionio_tpu_torch.streaming import scan_delta
    from predictionio_tpu_torch.streaming.updaters import FoldContext

    tmp, config, cli = project["tmp"], project["config"], project["cli"]
    app_id, iid, model = project["app_id"], project["iid"], project["model"]
    key = project["app"]["accessKey"]
    n_items = model.item_factors.shape[0]
    queries = make_queries(torch, ft, dev, rng, model, n_requests, n_items)
    registry = StorageRegistry(config)
    events = registry.get_events()
    engine = RecommendationEngine.apply()
    _, _, (algo,), _ = engine.make_components(
        engine_params_from_instance(engine, project["row"]))
    es_proc, es_port = start_eventserver(tmp, cli)
    rest = Rest(es_port, key)
    dep_proc = None
    try:
        dep_proc, port, deploy_wall_s = start_deploy(
            tmp, cli, iid, "--refresh-interval", str(STREAM_INTERVAL_S),
            "--feedback", "--accesskey", key, "--event-server-ip",
            "127.0.0.1", "--event-server-port", str(es_port))
        st0 = wait_status(port, dep_proc, "the refresher's baseline",
                          lambda s: s["refresh"]["ticks"].get("baseline"),
                          120)
        answers0 = serve_http(port, queries)
        wait_status(port, dep_proc, "the feedback of the first requests",
                    lambda s: s["feedback"]["sent"]
                    + s["feedback"]["dropped"] >= s["requests"], 120)
        wm_pred = events.ingest_watermark(app_id)
        st_noop = wait_status(
            port, dep_proc, "a tick over the predict events",
            lambda s: s["refresh"]["watermark"] == wm_pred, 60)
        ticks = st_noop["refresh"]["ticks"]
        if st0["refresh"]["watermark"] == wm_pred or not ticks.get(
                "noop") or set(ticks) - {"baseline", "noop"}:
            fail(f"the predict events' tick: ticks {ticks}")

        # 1. the REST drip, posted right after a tick
        n_ticks = sum(ticks.values())
        wait_status(port, dep_proc, "the next tick",
                    lambda s: sum(s["refresh"]["ticks"].values())
                    > n_ticks, 30)
        wm_before = events.ingest_watermark(app_id)
        drip = [{k: v for k, v in e.to_api_json().items()
                 if k != "creationTime"}
                for e in drip_events(model, rng, time.time())]
        half = len(drip) // 2
        with WatermarkLog(port) as wms:
            t_drip = time.perf_counter()
            statuses = [rest("POST", "/events.json", e)[0]
                        for e in drip[:half]]
            for lo in range(half, len(drip), 50):
                code, reply = rest("POST", "/batch/events.json",
                                   drip[lo:lo + 50])
                statuses += [r["status"] for r in reply] if code == 200 \
                    else [code]
            post_s = time.perf_counter() - t_drip
            if statuses != [201] * len(drip):
                fail(f"drip statuses {sorted(set(statuses))}")
            wm_after = events.ingest_watermark(app_id)
            st1 = wait_status(
                port, dep_proc, "the drip's fold",
                lambda s: s["refresh"]["watermark"] == wm_after, 120)
            seen_s = time.perf_counter() - t_drip
        ticks1 = st1["refresh"]["ticks"]
        # a fold reads the store's rows as they are when it runs, so a
        # tick inside the drip would fold events past its watermark: the
        # drip goes in right after a tick, well inside the interval
        if any(wm not in (wm_before, wm_after) for wm in wms.seen):
            fail(f"the drip ({post_s:.3f} s of posts) straddled a "
                 f"refresher tick: {len(wms.seen)} watermarks served")
        if ticks1.get("folded") != 1 or any(ticks1.get(k) for k in (
                "full_rebuild", "rolled_back", "failed", "no_hooks")):
            fail(f"the drip's ticks: {ticks1}")
        answers1 = serve_http(port, queries)
        # this process's own fold of the same delta, on the card, before
        # more ratings land (the predict events of these answers fold
        # as nothing)
        delta = scan_delta(events, app_id, None, wm_before, wm_after)
        fctx = FoldContext(store=events, app_id=app_id, channel_id=None,
                           since=wm_before, upto=wm_after,
                           ds_params={"app_name": "ml1m"})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        folded = algo.fold_in(model, delta, fctx)
        torch.cuda.synchronize()
        own_fold_s = time.perf_counter() - t0
        err_drip, untouched, unchanged = fold_gates(
            torch, ft, dev, queries, model, folded, delta.touched_users,
            delta.touched_items, answers0, answers1, n_items)

        # 2. sustained ingest beside paced queries
        t0_ms = int(time.time() * 1e3)
        paths = []
        batches = ingest_batches(model, rng, t0_ms)
        per = len(batches) // INGEST_CLIENTS
        for c in range(INGEST_CLIENTS):
            paths.append(tmp / f"ingest_{c}.json")
            paths[-1].write_text(json.dumps(
                batches[c * per:(c + 1) * per]))
        with Hammer(port, queries, pause_s=QS_PACE_S) as load:
            procs = [subprocess.Popen(
                [sys.executable, "-c", INGEST_CLIENT, str(es_port), key,
                 str(path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True) for path in paths]
            outs = [p_.communicate(timeout=600) for p_ in procs]
            if any(p_.returncode for p_ in procs):
                fail(f"an ingest client failed: {[o[1][-2000:] for o in outs]}")
            t_ing = time.perf_counter()
            wm_ingest = events.ingest_watermark(app_id)
            st2 = wait_status(
                port, dep_proc, "the refresher past the ingest",
                lambda s: covers(s["refresh"]["watermark"], wm_ingest), 300)
            caught_up_s = time.perf_counter() - t_ing
        reqs = [r for o, _ in outs for r in json.loads(o)]
        item_statuses = [x for r in reqs for x in r[3]]
        if len(reqs) != len(batches) or {r[2] for r in reqs} != {200} or \
                item_statuses != [201] * INGEST_EVENTS:
            fail(f"ingest statuses {sorted({r[2] for r in reqs})}, items "
                 f"{sorted(set(item_statuses))}")
        if load.failures:
            fail(f"{len(load.failures)} queries failed during the ingest: "
                 f"{load.failures[:3]}")
        ticks2 = st2["refresh"]["ticks"]
        if not ticks2.get("full_rebuild") or any(
                ticks2.get(k) for k in ("rolled_back", "failed")):
            fail(f"ticks after the ingest: {ticks2}")
        ingest_s = max(r[1] for r in reqs) - min(r[0] for r in reqs)
        lat = np.sort([r[1] - r[0] for r in reqs])
        start = datetime.fromtimestamp(t0_ms / 1e3, tz=timezone.utc)
        until = datetime.fromtimestamp((t0_ms + INGEST_EVENTS) / 1e3,
                                       tz=timezone.utc)
        stored = sum(1 for _ in events.find(app_id, start_time=start,
                                            until_time=until,
                                            event_names=["rate"]))
        if stored != INGEST_EVENTS:
            fail(f"the store holds {stored} of {INGEST_EVENTS} events")
        code, stats = rest("GET", "/stats.json")
        counted = sum(x["count"] for h in ("previousHour", "currentHour")
                      for x in stats[h] if x["event"] == "rate"
                      and x["status"] == 201)
        if code != 200 or counted != len(drip) + INGEST_EVENTS:
            fail(f"/stats.json counts {counted} rate events")

        # 3. a webhook and the reads
        segment = {"type": "track", "user_id": "quickstart-segment-user",
                   "event": "signup", "properties": {"plan": "pro"},
                   "timestamp": datetime.now(timezone.utc).isoformat()}
        code, reply = rest("POST", "/webhooks/segmentio.json", segment)
        wid = reply.get("eventId")
        listed = rest("GET", "/events.json?entityType=user&entityId="
                             "quickstart-segment-user")
        got = rest("GET", f"/events/{quote(wid or '', safe='')}.json")
        if code != 201 or listed[0] != 200 or [
                (e["eventId"], e["event"], e["properties"]["properties"])
                for e in listed[1]] != [(wid, "track", {"plan": "pro"})] \
                or got[0] != 200 or got[1]["eventId"] != wid:
            fail(f"webhook {code} {reply}, listed {listed}, got {got}")

        # 4. the feedback: one predict event per served query
        st_end = http_status(port)
        gate = launch_gate("quickstart", st_end, st_end["requests"],
                           straddle=2 * HAMMER_CLIENTS)
        stop_deploy(dep_proc)
        dep_proc = None
        predicts = list(events.find(app_id, event_names=["predict"]))
        if len(predicts) != st_end["requests"] or \
                st_end["feedback"]["dropped"] or any(
                    e.entity_type != "pio_pr"
                    or e.properties["engineInstanceId"] != iid
                    or "user" not in e.properties["query"]
                    for e in predicts):
            fail(f"{len(predicts)} predict events for {st_end['requests']} "
                 f"served queries; feedback {st_end['feedback']}")
        if rest("DELETE", f"/events/{quote(wid, safe='')}.json") != (
                200, {"message": "Found"}):
            fail("the webhook event's delete did not find it")
    finally:
        if dep_proc is not None:
            stop_deploy(dep_proc)
        stop_deploy(es_proc, "event server")

    # 5. pio eval on the card, rank 8 against the CPU
    (tmp / "qs_eval.py").write_text(EVAL_MODULE.format(
        folds=EVAL_FOLDS, k=EVAL_K, iters=TRAIN_ITERS, reg=TRAIN_REG,
        seed=project["seed"], threshold=EVAL_THRESHOLD,
        ranks=EVAL_RANKS))
    printed, eval_wall_s = cli("eval", "qs_eval.QuickstartEvaluation",
                               "qs_eval.QuickstartParams")
    inst = registry.get_meta_data_evaluation_instances().get(
        printed["evaluationInstanceId"])
    results = json.loads(inst.evaluator_results_json)["results"] \
        if inst is not None else []
    if inst is None or inst.status != EvaluationInstanceStatus.COMPLETED \
            or len(results) != len(EVAL_RANKS):
        fail(f"the evaluation instance: {inst}")
    card_scores = [r["score"] for r in results]
    sys.path.insert(0, str(tmp))
    mod = importlib.import_module("qs_eval")
    cache = _PrefixCache()
    ctx_cpu = RuntimeContext(registry=registry, device="cpu")
    t0 = time.perf_counter()
    cpu_score = mod.QuickstartEvaluation.metric.calculate(
        ctx_cpu, _eval_with_cache(mod.QuickstartEvaluation.engine, ctx_cpu,
                                  mod.QuickstartParams.engine_params_list[0],
                                  cache))
    cpu_eval_s = time.perf_counter() - t0
    if not abs(cpu_score - card_scores[0]) <= EVAL_TOL:
        fail(f"rank-8 Precision@{EVAL_K}: card {card_scores[0]}, CPU "
             f"{cpu_score}")
    folds = next(iter(cache.folds.values()))
    popularity = popularity_precision(folds, mod.QuickstartEvaluation.metric)
    tm = inst.runtime_conf["phase_timings"]

    # 6. pio batchpredict through K1
    bp_queries = []
    for ux in range(len(model.users)):
        q = {"user": model.users.inverse(ux), "num": K}
        if ux % 2:
            q["blackList"] = [model.items.inverse(int(x)) for x in rng.choice(
                n_items, int(rng.integers(1, WIDTH + 1)), replace=False)]
        bp_queries.append(q)
    lines = [json.dumps(q) for q in bp_queries]
    (tmp / "bp_in.jsonl").write_text("\n".join(lines) + "\n")
    bp, bp_wall_s = cli("batchpredict", "--input", "bp_in.jsonl",
                        "--output", "bp_out.jsonl")
    out_lines = (tmp / "bp_out.jsonl").read_text().splitlines()
    rows = [json.loads(x) for x in out_lines]
    if bp["predictions"] != len(bp_queries) or bp["engineInstanceId"] != \
            iid or [r["query"] for r in rows] != bp_queries:
        fail(f"batchpredict printed {bp}; the output's order is not the "
             "input's")
    err_bp = check_answers(torch, ft, dev, model, bp_queries,
                           [r["prediction"]["itemScores"] for r in rows],
                           n_items)
    ft.LAUNCHES = 0
    dep = load_deployment(engine, project["row"],
                          RuntimeContext(registry=registry, device=dev))
    plan = dep.algos[0]._serve_plan
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = list(predict_lines(dep, lines, chunk_size=BP_CHUNK))
    torch.cuda.synchronize()
    bp_s = time.perf_counter() - t0
    n = len(lines)
    expected = len(plan.buckets) + sum(
        -(-min(BP_CHUNK, n - lo) // max(plan.buckets))
        for lo in range(0, n, BP_CHUNK))
    if again != out_lines or not ft.LAUNCHES == plan.calls == expected:
        fail(f"batchpredict in process: same lines {again == out_lines}, "
             f"K1 launches {ft.LAUNCHES}, plan calls {plan.calls}, "
             f"expected {expected}")
    registry.close()

    out = {"phase": "quickstart", "users": len(model.users),
           "items": n_items, "engine_instance": iid,
           "deploy": {"command_to_serving_s": deploy_wall_s,
                      **st0["deploy_timings"]},
           "feedback_noop_ticks": ticks,
           "drip": {"events": len(drip), "single": half,
                    "batched": len(drip) - half, "post_s": post_s,
                    "touched_users": len(delta.touched_users),
                    "touched_items": len(delta.touched_items),
                    "seen_folded_after_s": seen_s,
                    "tick_s": st1["refresh"]["last_ticks"]["folded"],
                    "freshness_s": st1["refresh"]["freshness_s"],
                    "own_fold_s": own_fold_s, "max_abs_err": err_drip,
                    "untouched_answers": untouched,
                    "untouched_answers_identical": unchanged},
           "ingest": {"events": INGEST_EVENTS, "clients": INGEST_CLIENTS,
                      "batch": INGEST_BATCH, "requests": len(reqs),
                      "seconds": ingest_s,
                      "events_per_s": INGEST_EVENTS / ingest_s,
                      "request_ms": {"p50": 1e3 * lat[len(lat) // 2],
                                     "p99": 1e3 * lat[int(0.99 * (
                                         len(lat) - 1))]},
                      "pevlog_import_events_per_s": import_events_per_s,
                      "pevlog_insert_ms_alone": pevlog_insert_ms(tmp),
                      "drip_ms_per_event": 1e3 * post_s / len(drip),
                      "stored": stored, "stats_counted": counted,
                      "refresher_caught_up_after_s": caught_up_s,
                      "ticks": ticks2,
                      "last_ticks": st2["refresh"]["last_ticks"],
                      "queries": load.summary()},
           "feedback": {"served": st_end["requests"],
                        "predict_events": len(predicts),
                        **st_end["feedback"]},
           "serve": gate,
           "eval": {"folds": EVAL_FOLDS, "k": EVAL_K,
                    "threshold": EVAL_THRESHOLD, "ranks": EVAL_RANKS,
                    "evaluation_instance": inst.id, "status": inst.status,
                    "scores": card_scores, "best": printed["bestScore"],
                    "rank8_cpu_score": cpu_score, "cpu_eval_s": cpu_eval_s,
                    "popularity_score": popularity,
                    "command_wall_s": eval_wall_s,
                    "read_s": tm["read_s"], "per_fold": tm["folds"],
                    "peak_device_bytes": inst.runtime_conf.get(
                        "peak_device_bytes")},
           "batchpredict": {"queries": n, "max_abs_err": err_bp,
                            "command_wall_s": bp_wall_s,
                            "command_queries_per_s": n / bp_wall_s,
                            "in_process_s": bp_s,
                            "in_process_queries_per_s": n / bp_s,
                            "launches": ft.LAUNCHES,
                            "plan_calls": plan.calls,
                            "warmed_buckets": list(plan.buckets)},
           "launches": {"deploy": gate["launches"],
                        "batchpredict": ft.LAUNCHES}}
    emit(out)
    return out


# -- phase 15: the e-commerce and similar-product templates -------------------

EC_EXTRA_USERS, EC_EXTRA_VIEWS = 64, 20   # u0-u63: 20 further views each
EC_FRESH, EC_FRESH_VIEWS = 16, 5          # viewers appended after train
# e-commerce clients: each known user's query reads the user's history
# (about 1.3 s at 1.25 M events on an H100 machine's host) in the one
# drainer thread, and 8 clients queued requests past the server's 30-s
# submit deadline (504)
EC_CLIENTS = 4
SP_CATEGORIES, SP_LIKES = 20, 100_000
SP_REQUESTS, SP_UNKNOWN = 256, 16
# bench.py's streaming cooccurrence shape (its cooc section)
COOC_USERS, COOC_ITEMS, COOC_EVENTS, COOC_CAP = 5_000, 20_000, 500_000, 200
COOC_DENSE_ITEMS = 4_096                  # ops.cooccur._DENSE_ITEM_LIMIT
TEMPLATE_FOLD_TOL = 2e-3                  # the card's fold against the CPU's
TEMPLATES_T0_MS = 1_704_067_200_000       # 2024-01-01, bench.py's t_base
DAY_MS = 86_400_000


def templates_data(seed: int) -> dict:
    """The store's events as arrays, `bench_ecommerce_scale`'s generator
    from `seed`: 1,000,000 views of Zipf(1.3) mod 50,000 items by 5,000
    uniform users, spread over 8 days (view j on day j % 8, j // 8
    seconds in); the first 100,000 again as buys; 20 further views for
    each of u0-u63; for the similar-product template 1-3 of 20
    categories per item and 100,000 like/dislike events (4:1) over the
    same users and items; 16 viewers who come after the train."""
    rng = np.random.default_rng(seed + 15)
    j = np.arange(EC_VIEWS)
    d = {"u": rng.integers(0, EC_USERS, EC_VIEWS),
         "i": rng.zipf(1.3, EC_VIEWS) % EC_ITEMS,
         "t": TEMPLATES_T0_MS + (j % 8) * DAY_MS + (j // 8) * 1000}
    d["xu"] = np.repeat(np.arange(EC_EXTRA_USERS), EC_EXTRA_VIEWS)
    d["xi"] = rng.integers(0, EC_ITEMS, d["xu"].size)
    d["xt"] = TEMPLATES_T0_MS + 9 * DAY_MS + np.arange(d["xu"].size) * 1000
    k = np.arange(SP_LIKES)
    d["lu"] = rng.integers(0, EC_USERS, SP_LIKES)
    d["li"] = rng.zipf(1.3, SP_LIKES) % EC_ITEMS
    d["like"] = rng.random(SP_LIKES) < 0.8
    d["lt"] = TEMPLATES_T0_MS + (k % 8) * DAY_MS + (k // 8) * 1000 + 500
    d["cats"] = [sorted(rng.choice(SP_CATEGORIES, int(rng.integers(1, 4)),
                                   replace=False).tolist())
                 for _ in range(EC_ITEMS)]
    d["fresh"] = [rng.choice(EC_ITEMS // 10, EC_FRESH_VIEWS,
                             replace=False).tolist()
                  for _ in range(EC_FRESH)]
    return d


def templates_ingest(events, app_id: int, d: dict) -> dict:
    """The events into the port's PEVLOG DAO in process (`insert_batch`
    of 50,000, as bench.py ingests them); returns the count and the
    seconds."""
    from predictionio_tpu_torch.data.event import DataMap, Event, from_millis
    users = [f"u{n}" for n in range(EC_USERS)]
    items = [f"i{n}" for n in range(EC_ITEMS)]

    def pair(name, u, i, t):
        return Event(event=name, entity_type="user", entity_id=users[u],
                     target_entity_type="item", target_entity_id=items[i],
                     properties=DataMap({}), event_time=from_millis(t))

    def stream():
        yield Event(event="$set", entity_type="constraint",
                    entity_id="unavailableItems",
                    properties=DataMap({"items": [
                        items[n] for n in range(0, 2 * EC_UNAVAILABLE, 2)]}),
                    event_time=from_millis(TEMPLATES_T0_MS))
        for n, cats in enumerate(d["cats"]):
            yield Event(event="$set", entity_type="item", entity_id=items[n],
                        properties=DataMap({"categories": [
                            f"c{c}" for c in cats]}),
                        event_time=from_millis(TEMPLATES_T0_MS + n))
        u, i, t = d["u"].tolist(), d["i"].tolist(), d["t"].tolist()
        for name, count in (("view", EC_VIEWS), ("buy", EC_BUYS)):
            for n in range(count):
                yield pair(name, u[n], i[n], t[n])
        for n, (a, b, c) in enumerate(zip(d["xu"].tolist(),
                                          d["xi"].tolist(),
                                          d["xt"].tolist())):
            yield pair("view", a, b, c)
        for a, b, c, like in zip(d["lu"].tolist(), d["li"].tolist(),
                                 d["lt"].tolist(), d["like"].tolist()):
            yield pair("like" if like else "dislike", a, b, c)

    t0 = time.perf_counter()
    n, batch = 0, []
    for e in stream():
        batch.append(e)
        if len(batch) == 50_000:
            events.insert_batch(batch, app_id)
            n, batch = n + len(batch), []
    if batch:
        events.insert_batch(batch, app_id)
        n += len(batch)
    return {"events": n, "seconds": time.perf_counter() - t0}


def ranked(torch, scores, allowed, num: int):
    """The plain top-`num` of one row of scores under a host mask: a
    stable sort by (score desc, index asc), NEG_INF rows dropped;
    returns (ids, fp32 scores, the whole score row on the host)."""
    from predictionio_tpu_torch.ops.topk import NEG_INF
    s = scores.masked_fill(~torch.from_numpy(allowed).to(scores.device),
                           NEG_INF)
    order = torch.sort(s, descending=True, stable=True).indices[:num]
    top = s[order].cpu().numpy()
    keep = top > NEG_INF / 2
    return (order.cpu().numpy()[keep], top[keep],
            s.double().cpu().numpy())


def check_ranked(what: str, got: list, ids, scores, full, item_ix) -> float:
    """An answer (a list of {"item", "score"}) against the plain ranking:
    the same length, scores within TOL, and where an id differs, the
    answer's item scores within TOL of the plain one at that rank (a
    near-tie). Returns max |score diff|."""
    if len(got) != len(ids):
        fail(f"{what}: {len(got)} items, the plain version {len(ids)}")
    err = 0.0
    seen = set()
    for j, (g, i, s) in enumerate(zip(got, ids, scores)):
        gi = item_ix(g["item"])
        if gi is None or gi in seen:
            fail(f"{what}: unknown or repeated item {g['item']}")
        seen.add(gi)
        e = abs(g["score"] - float(s))
        err = max(err, e)
        if not e <= TOL + TOL * abs(float(s)):
            fail(f"{what} rank {j}: score {g['score']} vs plain {s}")
        if gi != int(i) and not abs(full[gi] - float(s)) <= TOL + TOL * abs(
                float(s)):
            fail(f"{what} rank {j}: item {g['item']} ({full[gi]}) vs plain "
                 f"{int(i)} ({s}) is no near-tie")
    return err


def ecommerce_queries(torch, dev, rng, model, d: dict, n_requests: int):
    """The request mix, scaled to `n_requests` (96: 48 known users of
    u0-u63, half with a 1-8 item blackList of their own top items; 16
    viewers who came after the train; 16 users with no events; 16
    known-user queries with categories; 64: 34, 10, 10, 10), each with
    what the template must answer: the plain version on the factors read
    back, the bans (unavailable + seen + blackList) recomputed from the
    generator."""
    n_items = model.item_factors.shape[0]
    ix = model.items.get
    unavail = [x for n in range(0, 2 * EC_UNAVAILABLE, 2)
               if (x := ix(f"i{n}")) is not None]
    seen: dict = {}
    for a, b in zip(d["u"][:EC_VIEWS].tolist(), d["i"].tolist()):
        if a < EC_EXTRA_USERS:
            seen.setdefault(a, set()).add(b)
    for a, b in zip(d["xu"].tolist(), d["xi"].tolist()):
        seen.setdefault(a, set()).add(b)
    # the buys are the first views again: they add no seen item
    member = np.zeros((n_items, SP_CATEGORIES), bool)
    for n, cats in enumerate(d["cats"]):
        if (x := ix(f"i{n}")) is not None:
            member[x, cats] = True
    items_unit = model.item_factors / (torch.linalg.vector_norm(
        model.item_factors, dim=1, keepdim=True) + 1e-9)
    sixth = max(1, n_requests // 6)
    n_known = n_requests - 3 * sixth
    known = rng.choice(EC_EXTRA_USERS, n_known,
                       replace=n_known > EC_EXTRA_USERS)
    specs = ([("known", int(u)) for u in known]
             + [("fresh", k % EC_FRESH) for k in range(sixth)]
             + [("ghost", k) for k in range(sixth)]
             + [("category", int(u)) for u in rng.choice(
                 EC_EXTRA_USERS, sixth)])
    out = []
    for n, (kind, who) in enumerate(specs):
        q = {"num": int(rng.integers(1, K + 1))}
        allowed = np.ones(n_items, bool)
        allowed[unavail] = False
        if kind in ("known", "category"):
            q["user"] = f"u{who}"
            allowed[[x for b in seen[who] if (x := ix(f"i{b}")) is not None]] \
                = False
            row = model.users.get(q["user"])
            scores = model.user_factors[row] @ model.item_factors.T
            if kind == "category":
                q["categories"] = [f"c{c}" for c in rng.choice(
                    SP_CATEGORIES, int(rng.integers(1, 3)), replace=False)]
                allowed &= member[:, [int(c[1:]) for c in q["categories"]]
                                  ].any(axis=1)
            elif n % 2:
                top, _, _ = ranked(torch, scores, allowed, 8)
                ban = top[:int(rng.integers(1, 9))].tolist()
                q["blackList"] = [model.items.inverse(x) for x in ban]
                allowed[ban] = False
        elif kind == "fresh":
            q["user"] = f"fresh{who}"
            viewed = [x for b in d["fresh"][who]
                      if (x := ix(f"i{b}")) is not None]
            allowed[viewed] = False
            # the latest 10 views, latest first (all 5 of them here)
            rows = torch.tensor(viewed[::-1][:10], device=dev)
            vec = model.item_factors[rows].mean(dim=0)
            vec = vec / (torch.linalg.vector_norm(vec) + 1e-9)
            scores = vec @ items_unit.T
        else:
            q["user"] = f"ghost{who}"
            scores = model.popularity.clone()
        ids, sc, full = ranked(torch, scores, allowed, min(q["num"],
                                                           n_items))
        out.append((kind, q, ids, sc, full, np.nonzero(~allowed)[0]))
    order = rng.permutation(len(out))
    return [out[n] for n in order]


def sp_expected(torch, models, units, members, q: dict):
    """What the similar-product engine must answer: the cosine of the
    mean query vector on each factor model read back (on the card), the
    template's own host `predict` for the cooccurrence model, averaged by
    `ScoreAverageServing`; returns (the result, {item: score})."""
    from predictionio_tpu_torch.models import similarproduct as sp
    query = sp.Query(**q)
    preds = []
    for model, unit, member in zip(models[:2], units, members):
        ixs = [x for it in q["items"] if (x := model.items.get(it))
               is not None]
        if not ixs:
            preds.append(sp.PredictedResult())
            continue
        n = unit.shape[0]
        allowed = np.ones(n, bool)
        if q.get("whiteList") is not None:
            allowed[:] = False
            allowed[[x for it in q["whiteList"]
                     if (x := model.items.get(it)) is not None]] = True
        allowed[[x for it in q.get("blackList", ())
                 if (x := model.items.get(it)) is not None]] = False
        allowed[ixs] = False
        if q.get("categories") is not None:
            allowed &= member[:, [int(c[1:]) for c in q["categories"]]
                              ].any(axis=1)
        vec = model.item_factors[torch.tensor(ixs, device=unit.device)
                                 ].mean(dim=0)
        vec = vec / (torch.linalg.vector_norm(vec) + 1e-9)
        ids, sc, _ = ranked(torch, vec @ unit.T, allowed, min(q["num"], n))
        preds.append(sp.PredictedResult(tuple(
            sp.ItemScore(model.items.inverse(int(i)), float(s))
            for i, s in zip(ids, sc))))
    cooc = sp.CooccurrenceAlgorithm(sp.CooccurrenceParams())
    preds.append(cooc.predict(models[2], query))
    res = sp.ScoreAverageServing().serve(query, preds)
    sums: dict = {}
    for p in preds:
        for s in p.itemScores:
            sums.setdefault(s.item, []).append(s.score)
    return res, {k: sum(v) / len(v) for k, v in sums.items()}


def similar_queries(rng, model, n_requests: int) -> list:
    """`n_requests` queries of 1-3 known items (Zipf-popular, so that the
    like model and the cooccurrence know most of them): half with 1-2
    categories, a quarter with a whiteList of 100 items, a quarter with a
    blackList of 1-10; `SP_UNKNOWN` with unknown items only."""
    keys = model.items.keys()
    out = []
    for n in range(n_requests - SP_UNKNOWN):
        q = {"items": [keys[int(x)] for x in np.unique(rng.zipf(
            1.3, int(rng.integers(1, 4))) % min(len(keys), 5_000))],
             "num": int(rng.integers(1, K + 1))}
        if n % 2:
            q["categories"] = [f"c{c}" for c in rng.choice(
                SP_CATEGORIES, int(rng.integers(1, 3)), replace=False)]
        if n % 4 == 0:
            q["whiteList"] = [keys[int(x)] for x in rng.choice(
                len(keys), 100, replace=False)]
        elif n % 4 == 2:
            q["blackList"] = [keys[int(x)] for x in rng.integers(
                0, 200, int(rng.integers(1, 11)))]
        out.append(q)
    out += [{"items": [f"nobody{k}"], "num": 5} for k in range(SP_UNKNOWN)]
    return [out[n] for n in rng.permutation(len(out))]


def cooccurrence_on_card(torch, dev, seed: int) -> dict:
    """`top_cooccurrences_streaming` at bench.py's shape (5,000 users,
    20,000 items, 500,000 Zipf(1.3) events, 200 items per user) on the
    card and on the CPU, which must agree bit for bit; then on a
    4,096-item catalog the dense route and the streaming route, on the
    card, bit for bit."""
    from predictionio_tpu_torch.ops import cooccur
    rng = np.random.default_rng(seed + 16)
    u = rng.integers(0, COOC_USERS, COOC_EVENTS)
    i = rng.zipf(1.3, COOC_EVENTS) % COOC_ITEMS
    out = {}
    runs = {}
    for where in ("cuda", "cpu"):
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        runs[where] = cooccur.top_cooccurrences_streaming(
            u, i, COOC_USERS, COOC_ITEMS, 20,
            max_items_per_user=COOC_CAP,
            device=dev if where == "cuda" else "cpu")
        torch.cuda.synchronize(dev)
        out[f"{where}_s"] = time.perf_counter() - t0
        if where == "cuda":
            out["peak_device_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                        - base)
    a, b = runs["cuda"], runs["cpu"]
    if not (np.array_equal(a.top_items, b.top_items)
            and np.array_equal(a.top_counts, b.top_counts)):
        fail("streaming cooccurrence on the card differs from the CPU's")
    small = i % COOC_DENSE_ITEMS
    t0 = time.perf_counter()
    dense = cooccur.top_cooccurrences_from_pairs(u, small, COOC_USERS,
                                                 COOC_DENSE_ITEMS, 20,
                                                 device=dev)
    dense_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stream = cooccur.top_cooccurrences_streaming(u, small, COOC_USERS,
                                                 COOC_DENSE_ITEMS, 20,
                                                 device=dev)
    stream_s = time.perf_counter() - t0
    if not (np.array_equal(dense.top_items, stream.top_items)
            and np.array_equal(dense.top_counts, stream.top_counts)):
        fail("the dense and the streaming cooccurrence routes differ")
    return {"users": COOC_USERS, "items": COOC_ITEMS, "events": COOC_EVENTS,
            "max_items_per_user": COOC_CAP, "bit_identical": True,
            "nonzero_counts": int((a.top_counts > 0).sum()), **out,
            "dense_vs_streaming": {"items": COOC_DENSE_ITEMS,
                                   "dense_s": dense_s,
                                   "streaming_s": stream_s,
                                   "bit_identical": True}}


def template_folds(torch, dev, config: dict, app_id: int, rows: dict,
                   models: dict, seed: int) -> dict:
    """Each template's `fold_in`, in process on the card, over a drip of
    192 events between two watermarks (48 new users, each viewing two
    known items, buying the first and liking or disliking the second),
    held against the same fold on the CPU: factors within
    TEMPLATE_FOLD_TOL, popularity equal, the cooccurrence merge bit for
    bit. New users keep the cooccurrence fold's per-user history reads
    in the drip's own segment."""
    import os
    from predictionio_tpu_torch.core.workflow import (
        engine_params_from_instance, resolve_engine)
    from predictionio_tpu_torch.data.event import DataMap, Event, from_millis
    from predictionio_tpu_torch.data.storage import StorageRegistry
    from predictionio_tpu_torch.streaming.updaters import FoldContext
    rng = np.random.default_rng(seed + 17)
    registry = StorageRegistry(config)
    events = registry.get_events()
    ec_model = models["ecommerce"][0]
    # items both factor models know (a new item forces a rebuild) that
    # no viewer after the train touched (a fold of an item re-solves it
    # over all its users, and no delta here folds those viewers)
    fresh = {f"i{b}" for viewed in templates_data(seed)["fresh"]
             for b in viewed}
    liked = models["similarproduct"][1].items
    known = [x for x in ec_model.items.keys()[:5_000]
             if x not in fresh and liked.get(x) is not None]
    drip, t = [], TEMPLATES_T0_MS + 11 * DAY_MS
    for k in range(48):
        a, b = rng.choice(len(known), 2, replace=False)
        for name, item in (("view", a), ("view", b), ("buy", a),
                           ("like" if rng.random() < 0.8 else "dislike",
                            b)):
            t += 1
            drip.append(Event(event=name, entity_type="user",
                              entity_id=f"drip{k}",
                              target_entity_type="item",
                              target_entity_id=known[int(item)],
                              properties=DataMap({}),
                              event_time=from_millis(t)))
    wm1 = events.ingest_watermark(app_id)
    events.insert_batch(drip, app_id)
    wm2 = events.ingest_watermark(app_id)
    prev = os.environ.get("PIO_INGEST_WORKERS")
    os.environ["PIO_INGEST_WORKERS"] = "4"
    out = {"events": len(drip)}
    try:
        for name in ("ecommerce", "similarproduct"):
            engine = resolve_engine(name)
            _, _, algos, _ = engine.make_components(
                engine_params_from_instance(engine, rows[name]))
            for a, model in zip(algos, models[name]):
                what = f"{name}.{type(a).__name__}"
                folded = {}
                for where in ("cuda", "cpu"):
                    m = model.to("cpu") if (where == "cpu" and callable(
                        getattr(model, "to", None))) else model
                    fctx = FoldContext(store=events, app_id=app_id,
                                       channel_id=None, since=wm1, upto=wm2)
                    t0 = time.perf_counter()
                    folded[where] = a.fold_in(m, None, fctx)
                    if where == "cuda":
                        torch.cuda.synchronize(dev)
                    out[f"{what}_{where}_s"] = time.perf_counter() - t0
                fc, fp = folded["cuda"], folded["cpu"]
                if fc is None or fp is None:
                    fail(f"{what}: the drip folded nothing")
                if hasattr(fc, "top"):
                    if not (np.array_equal(fc.top.top_items,
                                           fp.top.top_items)
                            and np.array_equal(fc.top.top_counts,
                                               fp.top.top_counts)):
                        fail(f"{what}: the card's merge differs from the "
                             "CPU's")
                    out[f"{what}_changed_rows"] = int(
                        (fc.top.top_counts != model.top.top_counts).any(
                            axis=1).sum())
                    continue
                if fc.item_factors.device != dev:
                    fail(f"{what}: the fold ran on {fc.item_factors.device}")
                err = 0.0
                for f in ("user_factors", "item_factors"):
                    a_, b_ = getattr(fc, f).cpu(), getattr(fp, f)
                    if not torch.allclose(a_, b_, rtol=TEMPLATE_FOLD_TOL,
                                          atol=TEMPLATE_FOLD_TOL):
                        fail(f"{what}: {f} of the card's fold differ from "
                             f"the CPU's by {(a_ - b_).abs().max()}")
                    err = max(err, float((a_ - b_).abs().max()))
                if hasattr(fc, "popularity") and not torch.equal(
                        fc.popularity.cpu(), fp.popularity):
                    fail(f"{what}: popularity differs")
                out[f"{what}_max_abs_err"] = err
                out[f"{what}_users"] = len(fc.users)
    finally:
        if prev is None:
            os.environ.pop("PIO_INGEST_WORKERS", None)
        else:
            os.environ["PIO_INGEST_WORKERS"] = prev
        registry.close()
    return out


def phase_templates(torch, ft, dev, rng, seed: int, n_requests: int) -> dict:
    """The e-commerce and the similar-product templates on the card
    through the command line, over SQLITE metadata and PEVLOG events (24-
    hour segments, the scan on 4 workers), on `templates_data`'s store.

    E-commerce (bench.py's engine: rank 32, 5 iterations, alpha 20,
    lambda 0.1, seed 1, 32 CG steps): build, train, deploy, then
    `n_requests` /queries.json (`ecommerce_queries`' mix): two alone,
    whose reads fill the server's replay cache, then the rest from
    EC_CLIENTS threads. Gates: COMPLETED with a solver
    residual below 1e-2; every answer against the plain version on the
    factors read back; no answer holds an unavailable, seen or
    blacklisted item; K1 launches = plan calls on `GET /`, and the plan
    answered known users.

    Similar product (als, likealgo and cooccurrence at the template's
    defaults; the cooccurrence streams at 50,000 items): build, train,
    deploy, SP_REQUESTS queries. Gates: every answer equals
    `sp_expected`; unknown items answer empty; a `similar_plan` over
    `ServeMesh((cuda:0,) * 3, forced=True)` answers as the
    single-device plan does.

    Then the cooccurrence alone on the card against the CPU, and each
    template's fold on the card against the CPU (`template_folds`)."""
    from predictionio_tpu_torch.data.event import DataMap, Event, from_millis
    from predictionio_tpu_torch.data.storage import (EngineInstanceStatus,
                                                     StorageRegistry)
    from predictionio_tpu_torch.native.eventlog import EventLog
    from predictionio_tpu_torch.ops import topk_sharded as ps

    t_phase = time.perf_counter()
    out = {"phase": "templates"}
    d = templates_data(seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_templates_") as tmp:
        tmp = Path(tmp)
        config = {"PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
                  "PIO_STORAGE_SOURCES_DB_PATH": str(tmp / "pio.db"),
                  "PIO_STORAGE_SOURCES_PEV_TYPE": "PEVLOG",
                  "PIO_STORAGE_SOURCES_PEV_PATH": str(tmp / "pevlog"),
                  "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
                  "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "PEV",
                  "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB"}
        cli = cli_runner(tmp, config, PIO_INGEST_WORKERS="4")
        if not EventLog(str(tmp / "probe.log")).uses_native:
            fail("the event journal is not the native (g++) build")
        app, _ = cli("app", "new", "shop")
        registry = StorageRegistry(config)
        events = registry.get_events()
        events.init(app["id"])
        ingest = templates_ingest(events, app["id"], d)
        out["ingest"] = {**ingest,
                         "events_per_s": ingest["events"] / ingest["seconds"]}
        (tmp / "ecommerce.json").write_text(json.dumps({
            "id": "ecommerce", "engineFactory": "ecommerce",
            "datasource": {"params": {"app_name": "shop"}},
            "algorithms": [{"name": "ecomm", "params": {
                "app_name": "shop", "rank": EC_RANK, "num_iterations": 5,
                "alpha": 20.0, "lambda_": 0.1, "seed": 1,
                "cg_iters": 32}}]}))
        (tmp / "similarproduct.json").write_text(json.dumps({
            "id": "similarproduct", "engineFactory": "similarproduct",
            "datasource": {"params": {"app_name": "shop"}},
            "algorithms": [{"name": "als", "params": {}},
                           {"name": "likealgo", "params": {}},
                           {"name": "cooccurrence", "params": {}}]}))
        rows, models = {}, {}
        for name in ("ecommerce", "similarproduct"):
            cli("build", "--engine-json", f"{name}.json")
            report, wall = cli("train", "--engine-json", f"{name}.json")
            if report["status"] != EngineInstanceStatus.COMPLETED:
                fail(f"the {name} instance is {report['status']}")
            tm = report["phaseTimings"]
            if not tm.get("solver_residual", 1.0) < 1e-2:
                fail(f"{name}: solver residual {tm.get('solver_residual')}"
                     " is not below 1e-2")
            models[name], rows[name] = read_models(
                config, report["engineInstanceId"], dev)
            out[f"{name}_train"] = {
                "engine_instance": report["engineInstanceId"],
                "status": report["status"], "command_wall_s": wall,
                **{k: tm[k] for k in sorted(tm) if k.endswith("_s")
                   or k in ("solver_residual", "blob_bytes")}}
        # viewers after the train: unknown to the model, so their
        # queries take the recent-view cosine path. fresh0's views arrive
        # late, stamped on days 0-4 (see the serve below); the others' on
        # day 10
        events.insert_batch([Event(
            event="view", entity_type="user", entity_id=f"fresh{k}",
            target_entity_type="item", target_entity_id=f"i{b}",
            properties=DataMap({}),
            event_time=from_millis(TEMPLATES_T0_MS + n * DAY_MS + 43_200_000
                                   if k == 0 else TEMPLATES_T0_MS
                                   + 10 * DAY_MS + 1000 * k + n))
            for k, viewed in enumerate(d["fresh"])
            for n, b in enumerate(viewed)], app["id"])

        # -- e-commerce: deploy and serve ---------------------------------
        ec_model = models["ecommerce"][0]
        iid = rows["ecommerce"].id
        queries = ecommerce_queries(torch, dev, rng, ec_model, d,
                                    n_requests)
        proc, port, deploy_s = start_deploy(
            tmp, cli, iid, "--engine-instance-id", iid)
        try:
            # the server's first reads replay the PEVLOG segments they
            # touch into its cache, in the request's time: fresh0's (days
            # 0-4), then a known user's (the rest), each alone, each well
            # inside the micro-batcher's 30-s deadline, where the whole
            # journal's replay in one request came within 4.4 s of it on
            # an H100 machine
            for kind, who in (("known", None), ("fresh", "fresh0")):
                first = next(n for n, x in enumerate(queries)
                             if x[0] == kind and who in (None, x[1]["user"]))
                queries.insert(0, queries.pop(first))
            answers = [http_post(port, q) for _, q, *_ in queries[:2]]
            t0 = time.perf_counter()
            answers += serve_http(port, [q for _, q, *_ in queries[2:]],
                                  EC_CLIENTS)
            wall = time.perf_counter() - t0
            status = http_status(port)
        finally:
            stop_deploy(proc)
        if status["plans"] != ["BucketedTopK"] or \
                status["plan_banned_widths"] != [EC_WIDTH]:
            fail(f"e-commerce GET /: plans {status['plans']}, widths "
                 f"{status['plan_banned_widths']}")
        launches = status["kernel_launches"]["fused_topk"]
        paths = status["serve_paths"][0]
        if not (launches == status["plan_calls"]
                and launches > len(status["plan_buckets"][0])
                and paths["plan"] > 0):
            fail(f"e-commerce: K1 launches {launches}, plan calls "
                 f"{status['plan_calls']}, paths {paths}")
        err, kinds = 0.0, {}
        for (kind, q, ids, sc, full, banned), (body, _) in zip(queries,
                                                               answers):
            got = body["itemScores"]
            err = max(err, check_ranked(f"e-commerce {kind} {q}", got, ids,
                                        sc, full, ec_model.items.get))
            bad = set(banned.tolist()) & {ec_model.items.get(g["item"])
                                          for g in got}
            if bad:
                fail(f"e-commerce {q['user']}: banned items {bad} served")
            kinds[kind] = kinds.get(kind, 0) + 1
        out["ecommerce_serve"] = {
            "requests": len(queries), "by_kind": kinds,
            "answers_checked": len(queries), "max_abs_err": err,
            "launches": launches, "plan_calls": status["plan_calls"],
            "plan_banned_width": status["plan_banned_widths"][0],
            "warmed_buckets": status["plan_buckets"][0],
            "batch_sizes": status["batch_sizes"],
            "queries_by_path": {k: paths[k] for k in ("plan", "generic",
                                                       "per_query")},
            "store_reads": paths["store_reads"],
            "ms_per_store_read": 1e3 * paths["store_read_s"]
            / max(1, paths["store_reads"]),
            "deploy": {"command_to_serving_s": deploy_s,
                       **status["deploy_timings"]},
            "first_requests_s": [t for _, t in answers[:2]],
            "clients": EC_CLIENTS, "wall_s": wall,
            "qps": (len(queries) - 2) / wall,
            "latency_ms": latency_ms(answers[2:])}

        # -- similar product: deploy and serve -----------------------------
        sp_models = models["similarproduct"]
        units, members = [], []
        for m in sp_models[:2]:
            units.append(m.item_factors / (torch.linalg.vector_norm(
                m.item_factors, dim=1, keepdim=True) + 1e-9))
            member = np.zeros((len(m.items), SP_CATEGORIES), bool)
            for x, key in enumerate(m.items.keys()):
                member[x, d["cats"][int(key[1:])]] = True
            members.append(member)
        sq = similar_queries(rng, sp_models[0], SP_REQUESTS)
        iid = rows["similarproduct"].id
        proc, port, deploy_s = start_deploy(
            tmp, cli, iid, "--engine-instance-id", iid)
        try:
            t0 = time.perf_counter()
            sanswers = serve_http(port, sq, 8)
            wall = time.perf_counter() - t0
            sstatus = http_status(port)
        finally:
            stop_deploy(proc)
        if sstatus["plans"] != ["BucketedSimilar", "BucketedSimilar",
                                "NoneType"]:
            fail(f"similar-product GET /: plans {sstatus['plans']}")
        serr, empty = 0.0, 0
        for q, (body, _) in zip(sq, sanswers):
            want, avg = sp_expected(torch, sp_models, units, members, q)
            got = body["itemScores"]
            if q["items"][0].startswith("nobody"):
                if got:
                    fail(f"unknown items {q['items']} answered {got}")
                empty += 1
                continue
            ids = [w.item for w in want.itemScores]
            scores = [w.score for w in want.itemScores]
            if len(got) != len(ids):
                fail(f"similar {q}: {len(got)} items, expected {len(ids)}")
            for j, (g, i, s) in enumerate(zip(got, ids, scores)):
                e = abs(g["score"] - s)
                serr = max(serr, e)
                if not e <= TOL + TOL * abs(s):
                    fail(f"similar {q} rank {j}: {g} vs {i} {s}")
                if g["item"] != i and not (
                        g["item"] in avg and abs(avg[g["item"]] - s)
                        <= TOL + TOL * abs(s)):
                    fail(f"similar {q} rank {j}: {g['item']} vs {i} is no "
                         "near-tie")
        # the sharded cosine plan on one card against the single-device one
        factors = sp_models[0].item_factors
        live = [q for q in sq if not q["items"][0].startswith("nobody")][:64]
        vecs = torch.stack([factors[torch.tensor(
            [sp_models[0].items.get(it) for it in q["items"]
             if sp_models[0].items.get(it) is not None], device=dev)].mean(0)
            for q in live])
        mask = np.ones((len(live), factors.shape[0]), bool)
        for r, q in enumerate(live):
            mask[r, [sp_models[0].items.get(it) for it in q["items"]
                     if sp_models[0].items.get(it) is not None]] = False
        single = ps.similar_plan(factors, k=K, buckets=(64,), device=dev)
        sharded = ps.similar_plan(factors, k=K, buckets=(64,),
                                  mesh=ps.ServeMesh((dev,) * 3, forced=True))
        if not isinstance(sharded, ps.ShardedBucketedSimilar):
            fail(f"similar_plan over a forced mesh built {sharded!r}")
        single.warm()
        sharded.warm()
        (s1, i1), (s3, i3) = single(vecs, mask), sharded(vecs, mask)
        full = (vecs / (torch.linalg.vector_norm(vecs, dim=1, keepdim=True)
                        + 1e-9)) @ units[0].T
        full = full.double().cpu().numpy()
        mesh_err = 0.0
        for r in range(len(live)):
            mesh_err = max(mesh_err, check_ranked(
                f"sharded similar row {r}",
                [{"item": int(x), "score": float(y)}
                 for x, y in zip(i3[r], s3[r])], i1[r], s1[r], full[r],
                lambda x: x))
        del single, sharded
        out["similarproduct_serve"] = {
            "requests": len(sq), "answers_checked": len(sq),
            "unknown_empty": empty, "max_abs_err": serr,
            "plans": sstatus["plans"], "plan_calls": sstatus["plan_calls"],
            "batch_sizes": sstatus["batch_sizes"],
            "deploy": {"command_to_serving_s": deploy_s,
                       **sstatus["deploy_timings"]},
            "wall_s": wall, "qps": len(sq) / wall,
            "latency_ms": latency_ms(sanswers),
            "sharded_plan_3_on_one_card": {"queries": len(live),
                                           "max_abs_err": mesh_err}}
        registry.close()
        out["cooccurrence"] = cooccurrence_on_card(torch, dev, seed)
        out["fold"] = template_folds(torch, dev, config, app["id"], rows,
                                     models, seed)
    out["templates_launches"] = out["ecommerce_serve"]["launches"]
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=320)
    ap.add_argument("--sharded-requests", type=int, default=160)
    ap.add_argument("--tiered-queries", type=int, default=64)
    ap.add_argument("--trained-requests", type=int, default=64)
    ap.add_argument("--lifecycle-requests", type=int, default=320)
    ap.add_argument("--streaming-requests", type=int, default=320)
    ap.add_argument("--quickstart-requests", type=int, default=320)
    ap.add_argument("--templates-requests", type=int, default=64)
    ap.add_argument("--only", choices=("serve_sharded", "train", "lifecycle",
                                       "streaming", "quickstart",
                                       "templates"),
                    help="run only the build and these phases (serve_sharded"
                         " for a machine with several cards; train for "
                         "train_parity, train and serve_trained; lifecycle "
                         "for parity and lifecycle; streaming for parity "
                         "and streaming; quickstart for parity and "
                         "quickstart; templates for parity and "
                         "templates), no kernels line")
    args = ap.parse_args()
    t_script = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs a card",
              file=sys.stderr)
        return 2
    from predictionio_tpu_torch.ops import fused_topk as ft

    dev = torch.device("cuda", 0)
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
          "grid": {str(b): ft.launch_plan(b, RANK, K, N_ITEMS)
                   for b in TIMED_BUCKETS},
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    rng = np.random.default_rng(args.seed)

    def train_phases():
        phase_train_parity(torch, dev, args.seed)
        trained = phase_train(torch, dev, card, args.seed)
        served = phase_serve_trained(torch, ft, dev, rng, trained,
                                     args.trained_requests)
        return trained[0], served

    def pevlog_phases(streaming: bool, quickstart: bool, sqlite_eps=None):
        """Phases streaming and quickstart over one PEVLOG project: one
        import and one train for both."""
        with tempfile.TemporaryDirectory(prefix="chip_smoke_pevlog_") as tmp:
            project = pevlog_project(Path(tmp), dev, args.seed)
            import_eps = (project["n_train"]
                          / project["imported"]["seconds"])
            st = phase_streaming(torch, ft, dev, rng, project,
                                 args.streaming_requests,
                                 sqlite_eps) if streaming else None
            qs = phase_quickstart(torch, ft, dev, rng, project,
                                  args.quickstart_requests,
                                  import_eps) if quickstart else None
        return st, qs

    if args.only is not None:
        if args.only == "serve_sharded":
            model, _ = make_model(torch, rng)
            phase_serve_sharded(torch, ft, dev, rng, model,
                                args.sharded_requests)
        elif args.only == "train":
            train_phases()
        elif args.only == "lifecycle":
            phase_parity(torch, ft, dev, rng)
            phase_lifecycle(torch, ft, dev, rng, args.seed,
                            args.lifecycle_requests)
        elif args.only == "templates":
            phase_parity(torch, ft, dev, rng)
            phase_templates(torch, ft, dev, rng, args.seed,
                            args.templates_requests)
        else:
            phase_parity(torch, ft, dev, rng)
            pevlog_phases(args.only == "streaming",
                          args.only == "quickstart")
        emit({"script_s": time.perf_counter() - t_script})
        print(smi_line(), flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    err = phase_parity(torch, ft, dev, rng)
    model, setup_s = make_model(torch, rng)
    serve = phase_serve(torch, ft, dev, rng, model, setup_s, args.requests)
    err_sh = phase_parity_sharded(torch, ft, dev, rng, model)
    serve_sh = phase_serve_sharded(torch, ft, dev, rng, model,
                                   args.sharded_requests)
    tiered = phase_serve_tiered(torch, ft, dev, rng, model,
                                args.tiered_queries)
    timing = phase_timing(torch, ft, dev, rng, card)
    timing_ec = phase_timing_ecommerce(torch, ft, dev, rng, card)
    timing_sh = phase_timing_sharded(torch, ft, dev, rng, model, card)
    del model
    _, served = train_phases()
    lifecycle = phase_lifecycle(torch, ft, dev, rng, args.seed,
                                args.lifecycle_requests)
    streaming, quickstart = pevlog_phases(
        True, True, lifecycle["import"]["events_per_s"])
    templates = phase_templates(torch, ft, dev, rng, args.seed,
                                args.templates_requests)

    main_row, shard_row = timing[64], timing_sh[64]
    emit({"script_s": time.perf_counter() - t_script})
    emit({"kernels": [{
        "name": "fused_topk", "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/fused_topk.cu",
        "replaces": "predictionio_tpu/ops/fused_topk.py:206",
        "launches": serve["launches"],
        "max_abs_err": max(err, serve["max_abs_err"]),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"], "bucket": 64,
        "tiered_launches": tiered["launches"],
        "trained_model_launches": served["launches"],
        "lifecycle_launches": lifecycle["serve"]["launches"],
        "streaming_launches": streaming["launches"],
        "quickstart_launches": quickstart["launches"],
        "templates_launches": templates["templates_launches"],
        "by_bucket": {str(b): r for b, r in timing.items()},
        "by_width": {str(EC_WIDTH): {str(b): r
                                     for b, r in timing_ec.items()}}}, {
        "name": "shard_local_candidates", "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/fused_topk.cu",
        "replaces": "predictionio_tpu/ops/fused_topk.py:176",
        "launches": serve_sh["shard_launches"],
        "max_abs_err": max(err_sh, serve_sh["max_abs_err"]),
        "ms": shard_row["ms"], "plain_ms": shard_row["plain_ms"],
        "bound_ms": shard_row["bound_ms"],
        "bound_by": shard_row["bound_by"],
        "library_ms": shard_row["library_ms"], "bucket": 64,
        "per_shard": shard_row["per_shard"],
        "by_bucket": {str(b): r for b, r in timing_sh.items()}}]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
