#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`predictionio_tpu_torch`).

    python3 chip_smoke.py [--seed 0] [--requests 320]
                          [--sharded-requests 160] [--tiered-queries 64]
                          [--trained-requests 64] [--lifecycle-requests 320]
                          [--streaming-requests 320]
                          [--quickstart-requests 320]
                          [--templates-requests 64]
                          [--only serve_sharded | train | lifecycle |
                                  streaming | quickstart | templates |
                                  classification | neural | wire |
                                  fleet | storage | ingest | obs |
                                  quality | pressure | elastic | chaos |
                                  steps]

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
  4b. wire    phase 4's model behind the serve plane of one server
              process, deployed through `cli.main.deploy` in this
              process, its clients in 4 separate client processes
              (started with subprocess, standard library only) of 16
              kept-alive connections each: the same 2,560 requests
              (1,280 {"user", "num"} bodies, which take the fast
              route; 640 with a blackList of up to 64 items, the
              generic route; 640 binary `application/x-pio-bin`
              frames) over the selector wire, then the threaded one.
              Gates: every answer checked against the plain version;
              K1 launches = plan calls = warmed buckets + drained
              chunks; /metrics counts every request sent. Then a shed
              run on the selector wire at max_inflight 8, a quarter of
              its 1,280 requests with a 0.5-ms deadline: 503s with
              Retry-After, 504s only for deadlined requests, every 200
              right, /metrics counting each status, the sheds and the
              expired deadlines as the clients saw them. Prints qps, p50
              and p99 by the clients' clock per wire and per route, the
              drained batches' `predict_batch` seconds over the wall
              (host time inside `predict_batch`, K1's launches and the
              plan's Python and its waits on the interpreter lock
              included; not the card's busy time), the
              `pio_serve_stage_seconds` split and the host's CPU count.
  4c. fleet   serving across processes and tenancy: phase 4's model
              written once into a SQLITE store as a COMPLETED instance
              (and a second one with a new item table), served through
              `serving.fleet.FleetServer` routers whose replicas load
              the instance as `cli deploy` does
              (`cli.main.fleet_replica_factory`); clients in 4 processes
              x 16 kept-alive connections with phase wire's mix. Every
              answer equals bit for bit the single-device K1 answer of
              its item table, and those answers are held to the plain
              version. (a) 3 in-process replicas, `items=3@fleet`: each
              replica's K1 over its 166,667-row slice
              (`ShardSliceTopK`), 1,280 requests merged by the router;
              per replica plan calls = warmed buckets + drained chunks,
              K1 launches = the plan calls, no K2 launch. (b) 2
              whole-catalog replicas rolled by `/reload` to the second
              instance while clients loop: no request fails, each
              answer is one table's, after the roll only the new one's.
              (c) `cli deploy --supervised 2` as a subprocess, the two
              children sharing the card: one child SIGKILLed under
              load, no request fails (the router retries), the child is
              respawned and admitted again (the seconds from the kill
              and from the new process's start); each child's K1
              launches = its plan calls = warmed buckets + drained
              chunks (its GET /, the killed child's read just before
              the kill); no child rebuilds the kernel library.
              (d) tenancy at the router (`--tenancy on`), two apps'
              access keys, one app at a 50 req/s rate quota: only its
              excess gets 429 with Retry-After, the other app all 200,
              the router's /metrics per-app counts equal the clients'.
              Prints qps, p50 and p99 by the clients' clock per part
              beside phase wire's direct selector pass of the same run.
  4d. storage the storage drivers and their recovery, with
              `tests/fakepg.py` (loaded by path) as the Postgres in this
              process. (a) Phase 4's model recorded twice as a COMPLETED
              instance (`CoreWorkflow.run_train`), metadata on POSTGRES,
              blobs on REPLICATED over three LOCALFS directories at
              quorum 2 (the third target down while instance 2 is
              written: its three tries fail, two targets acknowledge);
              one flipped byte in instance 2's first copy; `cli
              deploy`'s two steps in this process (the startup sweep
              included), 256 requests of phase wire's mix from 4 client
              processes: the deploy serves instance 2 and (b) read
              repair makes that copy equal its sibling's. Both copies
              corrupted and a TRAINING row with a 120-s-old heartbeat:
              `cli doctor --stale-after 60` reports both blobs and the
              row (exit 1), `doctor --repair` quarantines both
              (`.quarantine/` with a `.reason`) and fails the row (exit
              0); deploy still resolves instance 2, as the JAX package
              does, and its load fails on the missing blob; instance 1
              deployed by id serves. Every answer equals one card's K1
              answer bit for bit; K1 launches = plan calls = warmed
              buckets + drained chunks per deploy. (c) 25,000 planted ratings over
              MovieLens-1M's 6,040 x 3,706 (cut from 100,000 for the
              script's time limit) through `cli app new`, `import`
              (POSTGRES), `export`, `import` of that export into a
              SQLITE twin, its `export`, `train` on the card (rank 64,
              10 iterations) on both: the stores' rating columns equal
              element for element, the two exports the same lines, the
              two instances' 256 answers identical; then `app
              data-delete`, `channel-new`, an import of 1,000 events
              into the channel, `channel-delete`, `accesskey delete`.
              (d) 4,000 events in a PEVLOG store, a torn frame appended
              to a segment: `doctor` reports it, `--repair` truncates
              it, a later append is found and scanned. (e) An event
              server on POSTGRES (breaker threshold 3, recovery 2 s):
              the fake server crashes; POSTs answer 500 three times,
              then 503 with Retry-After, /ready is 503 naming the
              source; restarted on its port with its data, /ready comes
              back within the recovery time and a POST is stored.
              Parquet export/import and an OBJECTSTORE store on
              memory:// run where pyarrow and fsspec are installed; the
              line says which ran. Prints each part's seconds, the
              deploys' seconds and client-clock qps, p50 and p99, and
              each store's import and export events/s.
  4e. obs     the observatory (traces, the tsdb ring, the sampling
              profiler, the kernel probe), riding on phases that already
              deploy and train; its line comes after phase 17. (a) In
              phase 4b, once its selector pass is read, the same server
              (its scraper every 0.5 s) traced at sample 1: 1,280
              requests of phase 4b's mix from the same clients. Gates:
              every answer against the plain version; K1 launches =
              plan calls = drained chunks = the rise of
              `pio_kernel_launches_total`; `/traces.json` holds
              min(ring, 1,280) serve entries, each with `device_exec` >
              0 and its segments tiling its duration in slot order (within
              the 1-us fields' rounding); `pio_serve_seconds` rises by
              1,280, its exemplars since the ring's oldest entry in the
              ring; `/tsdb.json` has two serve-rate ticks since the pass
              began and `pio_device_memory_bytes{device="cuda:0"}` with
              128,000,000 <= in_use <= peak; `pio_plan_resident_bytes
              {bucket="factors"}` = 128,000,000; `/profile.json` has
              reactor, worker and drainer samples; no kernel build. (b)
              In phase 4c (c), the router and children traced at 0.01:
              32 requests with signed, sampled `X-PIO-Trace` headers,
              each id one `kind="router"` entry with a `proxy:` span in
              the router's ring and one `kind="serve"` entry in exactly
              one child's, under the router's span. (c) In phase ingest
              (c), its deploy traced at 0.01: `refresh_fold` spans =
              the folds its refresher counted; ingestd's profiler and
              scraper run and it stays off the card. (d) Phase 12's
              `cli train` with `--profile-dir`: one Chrome trace that
              parses, with CUDA kernel events; `kernelBuilds` 0. Prints
              the traced pass's qps, p50 and p99 beside the untraced
              selector pass, each segment's mean, and each part's
              seconds.
  4f. quality prediction quality and the reload canary, riding on phases
              that already serve; its line comes after phase 17. (a) In
              phase 4b, after 4e (a), the same server (quality on, the
              default): `/quality.json` counts every request it answered
              (app ""), with top-1 and margin quantiles and a frozen
              reference; then 1,280 requests of phase 4b's mix from the
              same clients on it and on a server deployed beside it with
              `quality=False` (`deploy --quality off`), untraced; every
              answer against the plain version; its count rises by
              1,280; the other answers `{"enabled": false}`; K1
              launches = plan calls. Prints both passes' qps, p50, p99.
              (b) In phase 4c (b), traced at 0.05 so that the ring holds
              serve entries: each replica's canary replays up to 16 of
              them through its old and new plans before the swap,
              report-only: a pass per replica, the overlap and score
              delta printed; per replica, the plans' calls = warmed
              buckets + drained chunks + the replays. (c) After it, the
              first instance served in this process with
              `canary_min_overlap` 0.5 under looping clients, then
              /reload, whose latest instance is the second table: a
              `CanaryVeto` (500), the first instance still serving, no
              failed request, every answer the first table's. (d) In
              phase 14, on its `deploy --feedback --attribution-s 600`:
              a conversion event (carrying `prId`) for each of the 32
              newest predict events; the deploy's joiner joins all 32
              (reward rate above 0) and its quality count equals the
              requests it answered.
  4g. pressure the memory-pressure guard and the watchdog's beats on
              servers in this process, after phase ingest, over the
              ML-1M PEVLOG project: its instance deployed as `deploy
              --refresh-interval 2 --feedback --tenancy on` (an event
              server in this process), a tiered deploy of its model
              beside it, keyed clients looping. The beats of the
              reactors, the drainer, the feedback loop, the page
              thread, the refresher and the joiner on
              `pio_thread_beat_age_seconds`; the guard's watermarks set
              2% and 4% of the card above this process's
              `memory_allocated` (the host's reading off), real device
              bytes allocated to cross them: at soft each trim (tsdb,
              trace, quality, tenant keys, prepared-ingest cache) runs
              once and releases bytes, 8 new requests get 503 with
              Retry-After (`pio_shed_total{surface="memory"}`), a
              request in flight answers right, /ready stays 200; freed,
              it serves again; `thread.refresher.stall` wedges the
              refresher for 15 s (its budget 11 s): one stall, one
              restart, a drip folded by the new thread, one refresher
              thread once the wedged one wakes; at hard the drain fires
              once, /ready fails and the server stops; a `cli ingestd`
              holds no /dev/nvidia* file. K1 launches = plan calls.
  4h. elastic the elastic fleet, in a process of its own (after every
              other phase): phase 4's model recorded as a
              COMPLETED instance in a SQLITE store, served by `cli
              deploy --supervised 1 --autoscale on --autoscale-min 1
              --autoscale-max 3 --batch-max 64` (the phase's
              PIO_AUTOSCALE_* and PIO_TSDB_INTERVAL_S, the JAX names)
              under `cli loadsim` (one process): one app over the
              model's users and items (Zipf 1.1, loadsim's fast,
              generic, binary and banned shapes), idle, a flash to 200
              req/s, idle again. (a) The autoscaler grows during the
              flash: most base ticks' member p99 below the threshold,
              the breach streak behind the first up on ticks inside the
              flash, the first up inside the flash, `scale1` admitted
              and answering; (b)
              every loadsim arrival is answered 200; (c) after the grow
              a checked pass of a quarter of phase 4b's mix through the
              router, every answer bit-identical to the single-device
              K1 answer, and on each child (a retired one at its last
              read, taken while it drained) K1 launches = plan calls =
              warmed buckets + drained chunks, no K2 launch, the
              children's answers summing to the router's; (d) after the load the
              target returns to 1, the retired children's processes are
              gone and none respawned, `retire` transitions rose and
              `eject` and the respawns did not; (e) /federate, the
              member qps and p99 gauges and /fleet.html cover every
              admitted member; (f) no child rebuilt the kernel library.
              Prints ready_s, each decision's second with the member
              p99 and qps points of the router's ring behind it,
              decision-to-admitted and retire-to-gone seconds, the peak
              child count and, before, during and after the flash,
              loadsim's arrivals scheduled and sent, late ones, and p50
              and p99 from the send and from the schedule.
              `CHIP_SMOKE_ELASTIC_CALIBRATE=r1,r2,...`
              with `--only elastic` runs the deploy with the autoscaler
              off instead and prints each rate's member p99, qps and
              batch queue-delay p99 (phase `elastic_calibration`).
  4i. chaos   the chaos drills, `cli top` and the service commands, in a
              process of its own once phases 9-11, 15, 16 and 17 have
              ended, beside the rest of the ML-1M chain: phase 4's model
              recorded as a COMPLETED instance in a SQLITE store whose
              app `chaos` (key CHAOSKEY, 2,000 ratings) its refresher
              reads. (a) The instance through `cli.main.deploy_instance`
              on the card: 64 of phase 4's queries against the plain
              version, K1 launches = plan calls; `cli top --port` prints
              its view, exit 0. (b) `cli chaos list` prints the nine
              drills; `cli chaos run refresher-die --json` (its tiny
              model trained on the card) exits 0 with an ok report. (c)
              `resilience.scenarios.run(name, trained=<that instance>,
              device=cuda:0)` for every drill (the six in-process ones
              first, the three over stub child processes last, beside
              the chain's tail), each a line of phase
              `chaos_drill` (requests, failures, notes, K1 launches,
              plan calls, the refresher's ticks): every report ok; in
              refresher-stall, refresher-die, lease-failover, mem-soft,
              hot-key and handoff-budget (the topologies that serve in
              this process) K1 launches rise and equal plan calls, none
              in replica-kill, flash-crowd, diurnal-1-N-1 (stub
              children); the refreshers tick a baseline, never `no_app`;
              no kernel build. (d) A store of its own where `cli eval`
              of the recommendation template ran on the card (300 x 200,
              6,000 planted ratings, two folds); `cli start-all` on free
              ports with its own pid and log directories: the
              dashboard's / lists the evaluation, its
              /engine_instances/<id>.json equals the stored results,
              /metrics.html and /traces.html answer; the admin server
              lists, creates and deletes an app; the event server
              stores an event; `cli daemon --name extra -- eventserver`
              starts a fourth; `cli stop-all` stops all four, their
              processes gone and their pidfiles removed.
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
              place and warm seconds, and the serve summary. Then
              what an operator runs (the deploy holds a server key):
              `cli redeploy` while a client process keeps querying (no
              request fails, /status.json's engineInstanceId flips, K1
              launches = the calls of both plans = two warmups +
              drained chunks); a /reload onto a COMPLETED instance whose
              blob is gone answers 500 and the old instance serves on;
              /stop without the key is 401; `cli undeploy` and the
              deploy process exits 0 within 30 s.
 13. streaming
              the same shape and split over SQLITE metadata and PEVLOG
              events (the scan on 4 spawned workers): app new, import
              (events/s beside phase 12's sqlite figure), build, train
              (these three run while phase 12 does, one process each)
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
              per-request p50/p99 beside the PEVLOG import and the
              threaded wire's reading; the event server on the selector
              wire, its /metrics counting the ingest; every
              status 201, all 20,000 found in the store and counted by
              /stats.json, a full rebuild with no failed query); a
              Segment.io webhook read back by entity and id, then
              deleted; one `predict` event per served query, none
              dropped; K1 launches = plan calls. Then (with `cli
              batchpredict` below started beside it) `cli eval`
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
              (the two templates side by side) and `deploy`, then --templates-requests (64; two alone,
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
              p99, ms per store read and the queries per serve path,
              and the PEVLOG sidecars' bytes and Bloom digests after
              the 1.25 M-event ingest.
 16. classification
              (a) bench.py's BASELINE config 2 (bench_classification's
              generator, 1,000,000 x 100, 4 classes): NB on the Poisson
              counts (a uint8 upload; pi and theta within 1e-5 of a
              float64 fit, accuracy within 0.005 of the closed form; a
              uint16 upload alike); the forest on the planted depth-2
              rule (10 trees, depth 5, 32 bins, every feature, seed 1):
              held-out accuracy at least 0.90, on a 100,000-row slice the
              card's forest equal to the CPU port's (a differing split
              only at a counted near-tie of the CPU's gains), the host
              loop and the device traversal equal; the level loop again
              with CUDA events (histogram, selection, routing ms per
              level beside the histogram's bound); predict ms and
              queries/s by route at 1-100,000 queries; logistic
              regression, 200 steps, its logits within 1e-4 x the
              largest of the CPU port's. (b) The template over SQLITE +
              PEVLOG: 200,000 users' `$set` events (the quickstart's
              rule), `cli build`, `train` (forest 8 x depth 4, naive,
              logreg), `deploy` and 256 /queries.json from 8 clients,
              `cli batchpredict` of 20,000 queries and the same lines
              through `core.batchpredict` in process, beside `cli eval`
              (Accuracy, 3 folds, naive and forest). Gates: COMPLETED;
              every answer equals the forest's batch_predict on the
              models read back, on the CPU; each algorithm's answers on
              the card equal its CPU answers; served batches stay on the
              forest's host loop, batchpredict chunks of 1,024 take its
              device traversal; eval NB above 0.85, the forest at least
              NB - 0.05; no K1 or K2 launch in the phase.
 17. neural   the two-tower and sequential recommenders (no TPU kernel
              on this path: attention, towers and transformer are
              PyTorch ops). (a) Attention on the card against float64 on
              the CPU at seqrec's width (B 256, S 32, H 2, Dh 32) and at
              S 512: causal or not, left-padded kv_mask; forward within
              2e-5, gradients finite and within 1e-4 x the largest, the
              blockwise recurrence (4 blocks) within 2e-5, padding rows
              exactly 0; ms per call beside SDPA's for the record.
              (b) bench_twotower's data and widths (5,000 x 2,000,
              200,000 pairs, 5% held out; emb 64, hidden 128, out 64,
              batch 4,096, 10 epochs) and (c) bench_seqrec's (20,000
              users, 1,000 items on the planted chain, seq_len 32, dim
              64, 2 heads, 2 layers, batch 256, 10 epochs) through
              `twotower_train` / `seqrec_train`: train_s, examples/s, ms
              per step by CUDA events beside the host's enqueue ms over
              that call's epochs after the first (its `on_step` hook),
              the profiler's busy share and operations per step over
              one more epoch's call, peak device bytes; seqrec's encode
              ms at batches 1/64/256. Gates: the first 20 step losses
              equal the CPU port's from the same init and batches within
              rtol 3e-6, the CPU's computed on one intra-op thread (its
              multi-threaded sums differ from run to run; one thread's
              do not), and the card's 20 again from the same init equal
              to them bit for bit (beside, not gated, the same reading with TF32
              matmuls: the net and its Adam are built first, the
              precision set after them, and the phase fails unless the
              control's steps ran with TF32 allowed; the flag it read is
              printed); recall@10 at least 4x random; hit-rate@10 at
              least 0.4 (beside the measured popularity baseline).
              (d) Both templates through `cli build`, `train`, `deploy
              --refresh-interval 2` over SQLITE + PEVLOG (two-tower: the
              generator's 200,000 events as views; seqrec: the
              generator's 20,000 users, each user's events on one of 30
              days): 256 requests from 8 clients, every answer
              against `score_and_rank` on the CPU from the served
              model's vectors (ids equal but for near-ties, scores within
              1e-5; unknown users empty); a 192-event drip folded by one
              warm-start epoch (fold tick, freshness_s); a new item
              rebuilt in full under 8 clients (0.05 s apart) with no
              failed request;
              `cli batchpredict` of 2,000 queries, each answer checked
              (queries/s); `template new --base twotower` and `--base
              seqrec` build and train. No K1 or K2 launch in the phase;
              the seconds of each part.

`--only serve_sharded` runs the build and phase 6 alone (for a machine
with several cards), `--only train` the build and phases 9-11,
`--only lifecycle` the build and phases 3 and 12, `--only streaming`
the build and phases 3 and 13, `--only quickstart` the build, phase 3,
phase 13's import and train, and phase 14, `--only templates` the
build and phases 3 and 15, `--only classification` the build and
phases 3 and 16, `--only neural` the build and phase 17, `--only wire`
the build and phases 3 and 4b, `--only fleet` the build, phase 3, one
selector pass of phase 4b's requests (its reference) and phase 4c,
`--only storage` the build and phases 3 and 4d, `--only obs` the build,
phase 3, phase 4's model and phase 4e (a) behind phase 4b's selector pass,
`--only quality` the build, phase 3, phase 4's model, phase 4b's selector
pass with 4e (a) and 4f (a), and phase 4c with 4f (b) and (c), `--only
pressure` the build, phase 3, phase 13's import and train and phase 4g,
`--only elastic` the build, phase 3, phase 4's model and phase 4h,
`--only chaos` the build, phase 3, phase 4's model and phase 4i,
`--only steps` the build and a diagnostic of phase 17's seqrec step
parity (the card's steps three times and beside a loaded card and host,
the CPU's at 1, 2, 4 and the default intra-op threads, twice each; it
gates nothing); none prints the kernels line (whose K1 entry counts phase
4b's launches as `wire_launches`, phase 4e (a)'s as `obs_launches`, phase
4c's as `fleet_launches`: its in-process parts' and its supervised
children's, the killed one's as read just before its kill, phase 4d's as
`storage_launches`, phase 4f's (a) and (c) as `quality_launches`, phase
4g's as `pressure_launches`, phase 4h's as `elastic_launches`: its
children's, a retired one's at its last read before it stopped, phase
4i's (a) and (c) as `chaos_launches`). Every
run prints its seconds (`script_s`), and every phase line its second in
the run (`at_s`).

The whole run's order: phases 1-4, 4b (with 4e (a) and 4f (a)) and
phase 8's timing, timing_ecommerce and timing_sharded, which have the
card and the host to themselves; phase 4c (with 4f (b) and (c)); then phases 9-11 (`--only
train`), 15, 16 and 17, each in a process of its own, started together
and run beside the rest: phases 4d, 5-7, 12-14 (the ML-1M chain, 4f (d)
inside 14) and 4g; once those four processes have ended, phase 4i
(`--only chaos`) in a process of its own beside what remains of the
chain. Their lines are passed on when they end (with run `at_s`), and a
failure of one fails the run. Then phase 4h, in a process of its own,
with the host to itself.

Then the kernels line, the nvidia-smi line and, last,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import atexit
import base64
import contextlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

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


_T_START = time.perf_counter()
# a phase process of a whole run (`start_phase_process`) counts its lines'
# at_s from the run's start, which the run exports here
if "CHIP_SMOKE_T0" in os.environ:
    _T_START -= max(0.0, time.time() - float(os.environ["CHIP_SMOKE_T0"]))


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - _T_START}
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# command-line processes started beside other work and not yet finished;
# a run that ends early (a failed gate) kills them
_BACKGROUND: set = set()


@atexit.register
def _stop_background() -> None:
    for proc in list(_BACKGROUND):
        if getattr(proc, "group", False):
            # a process group (ingestd and its scan workers): all of it
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            continue
        if getattr(proc, "phase", None):
            # a phase process exits through its own clean-up (its
            # SIGTERM handler), stopping what it started
            proc.terminate()
            try:
                proc.wait(timeout=30)
                continue
            except subprocess.TimeoutExpired:
                pass
        proc.kill()
        proc.wait()


def start_phase_process(only: str, seed: int):
    """`chip_smoke.py --only <only>` started beside this run (in its
    process group), its standard output to a file, its standard error
    copied line by line to this run's (the last lines kept for
    `finish_phase_process`, which waits for it)."""
    out = tempfile.TemporaryFile("w+")
    t0 = time.time() - (time.perf_counter() - _T_START)
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--only", only,
         "--seed", str(seed)],
        stdout=out, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "CHIP_SMOKE_T0": repr(t0),
             "CHIP_SMOKE_PHASE_PROCESS": "1"})
    proc.phase, proc.out, proc.err_tail = only, out, []

    def copy_stderr():
        for line in proc.stderr:
            sys.stderr.write(line)
            sys.stderr.flush()
            proc.err_tail = (proc.err_tail + [line.rstrip("\n")])[-200:]

    proc.copier = threading.Thread(target=copy_stderr, daemon=True)
    proc.copier.start()
    _BACKGROUND.add(proc)
    return proc


def finish_phase_process(proc, also: tuple = ()) -> dict:
    """Wait for a `start_phase_process` run, pass its phase lines (those
    of phases named `proc.phase...` or in `also`) on to this run's
    output and return its line of phase `proc.phase`, with the lines of
    `also` under their names; fail if it failed or printed no such
    line."""
    code = proc.wait(timeout=1200)
    _BACKGROUND.discard(proc)
    proc.copier.join(30)
    proc.out.seek(0)
    lines = proc.out.read().splitlines()
    proc.out.close()
    if code != 0:
        # its own failure last, where the end of this run's standard
        # error shows it
        why = [e for e in proc.err_tail
               if e.startswith("chip_smoke: FAILED")] or proc.err_tail[-5:]
        fail(f"phase {proc.phase}'s process exited {code}; its last "
             f"lines: {[line[:200] for line in lines[-3:]]}; its failure: "
             f"{why[-1][:3000] if why else None}")
    found, extra = None, {}
    for line in lines:
        if not line.startswith("{"):
            continue
        obj = json.loads(line)
        name = str(obj.get("phase", ""))
        if name.startswith(proc.phase) or name in also:
            print(line, flush=True)
            if name == proc.phase:
                found = obj
            elif name in also:
                extra[name] = obj
    missing = [n for n in also if n not in extra]
    if found is None:
        missing.insert(0, proc.phase)
    if missing:
        fail(f"phase {proc.phase}'s process printed no line of phase "
             f"{', '.join(missing)}")
    return {**found, **extra}


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


# -- phase wire: the serve plane from separate client processes ---------------

WIRE_PROCS, WIRE_CONNS = 4, 16       # client processes x keep-alive conns
WIRE_PLAIN, WIRE_BANNED, WIRE_BIN = 1_280, 640, 640
SHED_INFLIGHT = 8                    # the shed run's max_inflight
SHED_REQUESTS = 1_280                # a quarter of them deadlined
SHED_DEADLINE_MS = "0.5"             # below the 2-ms batching window
# REST ingest's events/s when the event server ran on the threaded wire
# (NVIDIA H100 80GB HBM3, 700 W), printed beside phase quickstart's
THREADED_REST_EVENTS_PER_S = (479, 656)
# phase obs: (a) the traced pass, half of phase wire's mix, on the
# selector pass's server, its scraper at OBS_TSDB_INTERVAL_S; (b) signed,
# sampled requests through the supervised fleet; (b) and (c) deploy at
# OBS_TRACE_SAMPLE (tracing on, few head samples, so that the rings keep
# the stitched and background entries)
OBS_PLAIN, OBS_BANNED, OBS_BIN = 640, 320, 320
OBS_TSDB_INTERVAL_S = "0.5"
QUALITY_REQUESTS = 1_280    # phase quality (a): each pass, half the mix
OBS_STITCHED = 32
OBS_TRACE_SAMPLE = "0.01"

WIRE_CLIENT = r"""
import http.client, json, sys, threading, time
reqfile, outfile, host, port, conns = sys.argv[1:6]
port, conns = int(port), int(conns)
reqs = json.load(open(reqfile))
pool = [http.client.HTTPConnection(host, port, timeout=120)
        for _ in range(conns)]
for c in pool:
    c.connect()
print("ready", flush=True)
sys.stdin.readline()
out = [None] * len(reqs)

def run(w):
    conn = pool[w]
    for n in range(w, len(reqs), conns):
        r = reqs[n]
        body = (bytes.fromhex(r["body"]) if r["bin"]
                else r["body"].encode())
        hdrs = {"Content-Type": ("application/x-pio-bin" if r["bin"]
                                 else "application/json")}
        if r.get("deadline"):
            hdrs["X-PIO-Deadline-Ms"] = r["deadline"]
        t0 = time.monotonic()
        try:
            conn.request("POST", r.get("path", "/queries.json"), body, hdrs)
            resp = conn.getresponse()
            data = resp.read().decode()
            out[n] = [resp.status, resp.getheader("Retry-After"), data,
                      t0, time.monotonic()]
        except Exception as e:
            out[n] = [-1, None, repr(e), t0, time.monotonic()]
            conn.close()
            conn = http.client.HTTPConnection(host, port, timeout=120)

threads = [threading.Thread(target=run, args=(w,)) for w in range(conns)]
for t in threads:
    t.start()
for t in threads:
    t.join()
json.dump(out, open(outfile, "w"))
"""


def wire_requests(torch, ft, dev, rng, model, n_plain: int, n_banned: int,
                  n_bin: int) -> list:
    """The request mix: `n_plain` {"user", "num"} bodies (the fast
    route), `n_banned` with a blackList of up to WIDTH items (the
    generic route: each row's own top 5 and random ones), `n_bin`
    binary frames of {"user", "num"}; shuffled. Each entry keeps its
    query for `check_answers`."""
    from predictionio_tpu_torch.utils.wire import encode_bin_query
    qs = make_queries(torch, ft, dev, rng, model, n_plain + n_banned + n_bin,
                      N_ITEMS)
    out = []
    for n, q in enumerate(qs):
        base = {"user": q["user"], "num": q["num"]}
        if n < n_plain:
            out.append({"kind": "plain", "query": base, "bin": False,
                        "body": json.dumps(base)})
        elif n < n_plain + n_banned:
            ban = q.get("blackList") or [model.items.inverse(
                int(x)) for x in rng.choice(N_ITEMS, WIDTH, replace=False)]
            full = {**base, "blackList": ban}
            out.append({"kind": "banned", "query": full, "bin": False,
                        "body": json.dumps(full)})
        else:
            out.append({"kind": "binary", "query": base, "bin": True,
                        "body": encode_bin_query(q["user"], q["num"]).hex()})
    order = rng.permutation(len(out))
    return [out[i] for i in order]


def wire_clients(port: int, reqs: list, tmp: Path) -> list:
    """`reqs` from WIRE_PROCS client processes (started with subprocess,
    stdlib only, never forked from this process) of WIRE_CONNS kept-alive
    connections each, released together once every connection is open;
    returns [status, Retry-After, body text, t_send, t_recv] per request
    (CLOCK_MONOTONIC, one clock for every process of the machine)."""
    procs, outs = [], []
    try:
        for p in range(WIRE_PROCS):
            req_f, out_f = tmp / f"wire_req_{p}.json", tmp / f"wire_out_{p}.json"
            req_f.write_text(json.dumps(
                [{k: r[k] for k in ("body", "bin", "deadline", "path")
                  if k in r} for r in reqs[p::WIRE_PROCS]]))
            proc = subprocess.Popen(
                [sys.executable, "-c", WIRE_CLIENT, str(req_f), str(out_f),
                 "127.0.0.1", str(port), str(WIRE_CONNS)],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
            procs.append(proc)
            outs.append(out_f)
        for proc in procs:
            if proc.stdout.readline().strip() != "ready":
                fail("a wire client did not come up")
        for proc in procs:
            proc.stdin.write("go\n")
            proc.stdin.flush()
        for proc in procs:
            if proc.wait(timeout=600) != 0:
                fail(f"a wire client exited {proc.returncode}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    res = [None] * len(reqs)
    for p, out_f in enumerate(outs):
        for j, r in enumerate(json.loads(out_f.read_text())):
            res[p + j * WIRE_PROCS] = r
    return res


def prom(text: str) -> dict:
    """Prometheus text -> {'name{labels}': value}."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


def prom_sum(series: dict, prefix: str, suffix: str = "") -> float:
    return sum(v for k, v in series.items()
               if k.startswith(prefix) and k.endswith(suffix))


def lat_summary(res, idx) -> dict:
    lat = np.sort([res[i][4] - res[i][3] for i in idx])
    if not len(lat):
        return {"requests": 0}
    t0, t1 = min(res[i][3] for i in idx), max(res[i][4] for i in idx)
    return {"requests": len(lat), "qps": len(lat) / (t1 - t0),
            "p50_ms": 1e3 * lat[len(lat) // 2],
            "p99_ms": 1e3 * lat[int(0.99 * (len(lat) - 1))]}


def wire_run(torch, ft, dev, model, reqs, tmp: Path, wire: str,
             max_inflight: int = 0,
             log_file: Optional[Path] = None,
             obs_reqs: Optional[list] = None) -> dict:
    """Deploy `model` through `cli.main.deploy` on `wire` with a registry
    of its own, send `reqs` from the client processes, read GET / and
    /metrics, stop. The kernel's counts are set to 0 just before the
    deploy and read after the last answer. With `log_file` the server's
    structured log runs at INFO, as a default deploy's does, its lines
    written to that file; otherwise at this run's PIO_OBS_LOG_LEVEL.
    With `obs_reqs` the server's scraper ticks every OBS_TSDB_INTERVAL_S,
    and after those reads the same server takes phase obs's traced pass
    of `obs_reqs` (`obs_pass`, its result under "obs"), then phase
    quality (a) (`quality_pass`, under "quality")."""
    import logging
    from predictionio_tpu_torch.cli.main import deploy
    from predictionio_tpu_torch.obs import MetricsRegistry, get_logger
    get_logger("wire")                 # the obs log tree exists
    log_root = logging.getLogger("pio.torch.obs")
    saved_log = (log_root.handlers[:], log_root.level)
    if log_file is not None:
        handler = logging.FileHandler(log_file)
        handler.setFormatter(logging.Formatter("%(message)s"))
        log_root.handlers = [handler]
        log_root.setLevel(logging.INFO)
    ft.LAUNCHES = 0
    ft.SHARD_LAUNCHES = 0
    with (env_set(PIO_TSDB_INTERVAL_S=OBS_TSDB_INTERVAL_S)
          if obs_reqs is not None else contextlib.nullcontext()):
        server = deploy(model, port=0, batch_max=64, wire=wire,
                        max_inflight=max_inflight,
                        metrics=MetricsRegistry())
    if server.wire != wire:
        fail(f"asked for the {wire} wire, got {server.wire}")
    plan = server.deployment.algos[0]._serve_plan
    predict = server.deployment.predict_batch
    batch_s = []

    def timed_predict(queries):
        t = time.perf_counter()
        try:
            return predict(queries)
        finally:
            batch_s.append(time.perf_counter() - t)

    server.deployment.predict_batch = timed_predict
    try:
        res = wire_clients(server.port, reqs, tmp)
        launches, plan_calls = ft.LAUNCHES, plan.calls
        sizes = server.batcher.batch_sizes()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/metrics",
                timeout=60) as resp:
            series = prom(resp.read().decode())
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/",
                                    timeout=60) as resp:
            status = json.loads(resp.read())
        obs = (obs_pass(torch, ft, dev, model, server, plan, obs_reqs, tmp)
               if obs_reqs is not None else None)
        quality = (quality_pass(torch, ft, dev, model, server, plan,
                                reqs[:QUALITY_REQUESTS], tmp)
                   if obs_reqs is not None else None)
    finally:
        server.stop()
        server.deployment.predict_batch = predict
        if log_file is not None:
            log_root.handlers[0].close()
            log_root.handlers, level = saved_log
            log_root.setLevel(level)
    expected = len(plan.buckets) + sum(
        c * -(-n // plan.max_bucket) for n, c in sizes.items())
    if not launches == plan_calls == expected:
        fail(f"wire {wire}: K1 launches {launches}, plan calls "
             f"{plan_calls}, expected {expected} (warmup + drained chunks)")
    bad = [r for r in res if r is None or r[0] == -1]
    if bad:
        fail(f"wire {wire}: {len(bad)} requests failed on the client: "
             f"{bad[0]}")
    t0, t1 = min(r[3] for r in res), max(r[4] for r in res)
    return {"res": res, "series": series, "status": status,
            "sizes": sizes, "launches": launches, "plan_calls": plan_calls,
            "expected_calls": expected, "batch_s": batch_s,
            "wall_s": t1 - t0, "buckets": list(plan.buckets), "obs": obs,
            "quality": quality}


def chunks(sizes: dict, max_bucket: int) -> int:
    """Plan calls of drained batches {size: count}: one per chunk."""
    return sum(c * -(-n // max_bucket) for n, c in sizes.items())


def trace_tiles(entry: dict) -> bool:
    """An entry's stage segments in slot order, each starting where the
    last ended and together spanning its duration, within the 1-us
    rounding of the JSON fields (0.5 us a field)."""
    stages = [s for s in entry["spans"] if ":" not in s["name"]]
    if not stages:
        return False
    tol = 5e-4 * (len(stages) + 1)
    if abs(sum(s["dur_ms"] for s in stages) - entry["duration_ms"]) > tol:
        return False
    return all(abs(a["start_ms"] + a["dur_ms"] - b["start_ms"]) <= 1.5e-3
               for a, b in zip(stages, stages[1:]))


def obs_pass(torch, ft, dev, model, server, plan, reqs, tmp: Path) -> dict:
    """Phase obs (a), on the selector pass's server once that pass is
    read: the flight recorder at sample 1 into the server's registry,
    the profiler's samples cleared, then `reqs` from the same client
    processes. Gates: every answer against the plain version; K1
    launches = plan calls = drained chunks = the rise of
    `pio_kernel_launches_total`; `/traces.json` holds min(ring, n) serve
    entries, each with `device_exec` > 0 and its segments tiling its
    duration in slot order; `pio_serve_seconds` rises by n, and its
    exemplars since the ring's oldest entry are in the ring;
    `/tsdb.json` has two ticks of the serve rate since the pass began
    and `pio_device_memory_bytes{device="cuda:0"}` with the plan's item
    table <= in_use <= peak; `pio_plan_resident_bytes{bucket="factors"}`
    is the table's bytes; `/profile.json` has reactor, worker and
    drainer samples; no kernel build. Tracing is off again after it.
    The card's label ("cuda:0") is the plan's factors' device."""
    from predictionio_tpu_torch.obs import get_profiler, trace
    t_part = time.perf_counter()
    base = f"http://127.0.0.1:{server.port}"
    count_key = 'pio_serve_seconds_count{app=""}'
    table_bytes = N_ITEMS * RANK * 4       # the plan's pinned item table
    card = f"{plan.factors.device.type}:{plan.factors.device.index or 0}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=60) as resp:
            body = resp.read().decode()
        return prom(body) if path == "/metrics" else json.loads(body)

    m0 = get("/metrics")
    launches0, calls0 = ft.LAUNCHES, plan.calls
    sizes0 = server.batcher.batch_sizes()
    rec = trace.configure(sample=1.0, metrics=server.metrics)
    ring = trace.DEFAULT_RING
    get_profiler().reset()
    t_wall0 = time.time()
    try:
        res = wire_clients(server.port, reqs, tmp)
        end = time.monotonic() + 30
        # the last responses' traces finish after their bytes are sent;
        # waited for in this process (a request now would be traced)
        hist0 = server.metrics.histogram(
            "pio_serve_seconds", "", labels=("app",),
            buckets=trace.SERVE_BUCKETS).labels(app="")
        while sum(e["kind"] == "serve" for e in rec.snapshot()) < min(
                ring, len(reqs)) or hist0.count < m0.get(count_key,
                                                         0.0) + len(reqs):
            if time.monotonic() > end:
                fail("obs (a): the traced requests' traces never finished")
            time.sleep(0.01)
        launches, calls = ft.LAUNCHES - launches0, plan.calls - calls0
        sizes = server.batcher.batch_sizes()
        drained = chunks({n: c - sizes0.get(n, 0) for n, c in sizes.items()},
                         plan.max_bucket)
        traces = get("/traces.json")
        while True:
            tsdb = get("/tsdb.json?series=pio_serve_seconds,"
                       "pio_device_memory_bytes,pio_plan_resident_bytes")
            rate = tsdb["series"].get("pio_serve_seconds{app=}:rate",
                                      {"points": []})["points"]
            ticks = [pt for pt in rate if pt[0] >= t_wall0]
            if len(ticks) >= 2 or time.monotonic() > end:
                break
            time.sleep(0.1)
        profile = get("/profile.json")
        m1 = get("/metrics")
        hist = server.metrics.snapshot()["pio_serve_seconds"]["series"]
    finally:
        trace.configure(sample=0.0)
    bad = [r for r in res if r is None or r[0] != 200]
    if bad:
        fail(f"obs (a): {len(bad)} traced requests failed: {bad[0]}")
    err = check_wire_answers(torch, ft, dev, model, reqs, res, "obs (a)")
    k1 = 'pio_kernel_launches_total{kernel="fused_topk"}'
    metric_launches = m1.get(k1, 0.0) - m0.get(k1, 0.0)
    if not launches == calls == drained == metric_launches:
        fail(f"obs (a): K1 launches {launches}, plan calls {calls}, drained "
             f"chunks {drained}, pio_kernel_launches_total rose "
             f"{metric_launches}")
    builds = m1.get("pio_kernel_builds_total", 0.0) - m0.get(
        "pio_kernel_builds_total", 0.0)
    if builds:
        fail(f"obs (a): {builds} kernel builds after warmup")
    serve = [e for e in traces["traces"] if e["kind"] == "serve"]
    if len(serve) != min(ring, len(reqs)):
        fail(f"obs (a): /traces.json holds {len(serve)} serve entries, "
             f"want min({ring}, {len(reqs)})")
    no_exec = [e for e in serve if not any(
        s["name"] == "device_exec" and s["dur_ms"] > 0 for s in e["spans"])]
    untiled = [e for e in serve if not trace_tiles(e)]
    if no_exec or untiled:
        fail(f"obs (a): {len(no_exec)} entries without device_exec > 0, "
             f"{len(untiled)} whose segments do not tile the duration: "
             f"{(no_exec or untiled)[0]}")
    counted = m1.get(count_key, 0.0) - m0.get(count_key, 0.0)
    if counted != len(reqs):
        fail(f"obs (a): pio_serve_seconds counted {counted} of {len(reqs)}")
    in_ring = {e["trace_id"] for e in serve}
    oldest = min(e["ts"] for e in serve)
    exemplars = [x for row in hist if row["labels"] == {"app": ""}
                 for x in row.get("exemplars", ())]
    recent = [x for x in exemplars if x["ts"] >= oldest]
    if not recent or any(x["trace_id"] not in in_ring for x in recent):
        fail(f"obs (a): pio_serve_seconds exemplars {exemplars} not in the "
             "ring")
    mem = {k: v["points"] for k, v in tsdb["series"].items()
           if k.startswith(f"pio_device_memory_bytes{{device={card},")}
    in_use = dict(mem.get(f"pio_device_memory_bytes{{device={card},"
                          "kind=in_use}", ()))
    peak = dict(mem.get(f"pio_device_memory_bytes{{device={card},"
                        "kind=peak}", ()))
    both = sorted(set(in_use) & set(peak))
    factors = tsdb["series"].get(
        f"pio_plan_resident_bytes{{bucket=factors,device={card}}}",
        {"points": []})["points"]
    if len(ticks) < 2 or not both or not (
            table_bytes <= in_use[both[-1]] <= peak[both[-1]]) or \
            not factors or factors[-1][1] != table_bytes:
        fail(f"obs (a): /tsdb.json serve-rate ticks {ticks}, device memory "
             f"{mem}, plan factors {factors[-1:] if factors else None}")
    roles = profile["roles"]
    if any(roles.get(r, {}).get("samples", 0) <= 0
           for r in ("reactor", "worker", "drainer")):
        fail(f"obs (a): /profile.json roles {roles}")
    segments = {}
    for e in serve:
        for sp in e["spans"]:
            segments.setdefault(sp["name"], []).append(sp["dur_ms"])
    return {
        "requests": len(reqs), "answers_checked": len(reqs),
        "max_abs_err": err, "launches": launches, "plan_calls": calls,
        "pio_kernel_launches_rise": metric_launches, "kernel_builds": builds,
        "kernel_builds_total": m1.get("pio_kernel_builds_total", 0.0),
        "ring": ring, "serve_entries": len(serve),
        "serve_seconds_counted": counted,
        "exemplars_in_ring": len(recent), "exemplars": len(exemplars),
        "serve_rate_ticks": len(ticks),
        "device_memory_bytes": {"in_use": in_use[both[-1]],
                                "peak": peak[both[-1]]},
        "plan_factor_bytes": factors[-1][1],
        "profile": {"samples": profile["samples"],
                    "shares": {r: v["share"] for r, v in roles.items()}},
        "all": lat_summary(res, range(len(res))),
        "by_route": {kind: lat_summary(res, [
            i for i, r in enumerate(reqs) if r["kind"] == kind])
            for kind in ("plain", "banned", "binary")},
        "segment_mean_ms": {k: sum(v) / len(v)
                            for k, v in sorted(segments.items())},
        "seconds": time.perf_counter() - t_part}


def quality_json(port: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/quality.json",
                                timeout=60) as resp:
        return json.loads(resp.read())


def quality_pass(torch, ft, dev, model, server, plan, reqs,
                 tmp: Path) -> dict:
    """Phase quality (a), on the selector pass's server after phase obs
    (a): `/quality.json` counts every answered request of the server
    (the selector pass's and obs (a)'s, all app ""), with top-1 and
    margin quantiles and a frozen reference; then `reqs` from the client
    processes, in turns, on a server deployed beside it with
    `quality=False` (`deploy --quality off`) and on it (quality on, the
    default): off, on, off, on, untraced. Gates: every answer against
    the plain version; the quality-on server's count rises by 2 x
    len(reqs); the quality-off server answers `{"enabled": false}`; K1
    launches = plan calls = drained chunks on the first, warmed buckets +
    drained chunks on the second."""
    from predictionio_tpu_torch.cli.main import deploy
    from predictionio_tpu_torch.obs import MetricsRegistry
    t_part = time.perf_counter()
    q0 = quality_json(server.port)
    app0 = q0["apps"].get("", {})
    served = server.request_count
    if not q0["enabled"] or app0.get("n") != served or \
            set(q0["apps"]) != {""} or not app0["quantiles"].get("top1") \
            or not app0["quantiles"].get("margin") or \
            (app0.get("reference") or {}).get("n", 0) < 50:
        fail(f"quality (a): /quality.json {json.dumps(q0)[:600]} after "
             f"{served} answered requests")
    launches0, calls0 = ft.LAUNCHES, plan.calls
    sizes0 = server.batcher.batch_sizes()
    off = deploy(model, port=0, batch_max=64, quality=False,
                 metrics=MetricsRegistry())
    try:
        plan_off = off.deployment.algos[0]._serve_plan
        passes = {"on": [], "off": []}
        for name in ("off", "on", "off", "on"):
            passes[name].append(wire_clients(
                (server if name == "on" else off).port, reqs, tmp))
        q_off = quality_json(off.port)
        want_off = len(plan_off.buckets) + chunks(
            off.batcher.batch_sizes(), plan_off.max_bucket)
    finally:
        off.stop()
    launches = ft.LAUNCHES - launches0
    calls = plan.calls - calls0
    sizes = server.batcher.batch_sizes()
    drained = chunks({n: c - sizes0.get(n, 0) for n, c in sizes.items()},
                     plan.max_bucket)
    q1 = quality_json(server.port)
    if q1["apps"][""]["n"] != served + 2 * len(reqs):
        fail(f"quality (a): the count rose {q1['apps']['']['n'] - served} "
             f"for {2 * len(reqs)} requests")
    if not calls == drained or launches != calls + plan_off.calls:
        fail(f"quality (a): K1 launches {launches}, plan calls {calls} + "
             f"{plan_off.calls}, drained chunks {drained}")
    if q_off != {"enabled": False, "apps": {}}:
        fail(f"quality (a): the quality-off server's /quality.json {q_off}")
    if plan_off.calls != want_off:
        fail(f"quality (a): the quality-off server's plan calls "
             f"{plan_off.calls}, expected {want_off}")
    err = 0.0
    for name, runs in passes.items():
        for res in runs:
            bad = [r for r in res if r is None or r[0] != 200]
            if bad:
                fail(f"quality (a), quality {name}: {len(bad)} requests "
                     f"failed: {bad[0]}")
            err = max(err, check_wire_answers(torch, ft, dev, model, reqs,
                                              res, f"quality (a) {name}"))
    lat = {name: [lat_summary(res, range(len(res))) for res in runs]
           for name, runs in passes.items()}
    qps = {name: sum(x["qps"] for x in v) / len(v) for name, v in lat.items()}
    a = q1["apps"][""]
    return {"answered_before": served, "counted_before": app0["n"],
            "counted_after": a["n"], "reference_n": a["reference"]["n"],
            "top1": a["quantiles"].get("top1"),
            "margin": a["quantiles"].get("margin"),
            "windows_5m": a["windows"]["5m"],
            "requests_per_pass": len(reqs), "max_abs_err": err,
            "launches": launches,
            "quality_on": lat["on"], "quality_off": lat["off"],
            "qps_on_over_off": qps["on"] / qps["off"],
            "seconds": time.perf_counter() - t_part}


def check_wire_answers(torch, ft, dev, model, reqs, res, what) -> float:
    """Every 200 against the plain version (`check_answers`)."""
    ok = [i for i, r in enumerate(res) if r[0] == 200]
    if not ok:
        fail(f"{what}: no request answered 200")
    return check_answers(torch, ft, dev, model,
                         [reqs[i]["query"] for i in ok],
                         [json.loads(res[i][2])["itemScores"] for i in ok],
                         N_ITEMS)


def stage_split(series: dict) -> dict:
    out = {}
    for stage in ("extract", "supplement", "predict", "serve"):
        n = series.get(f'pio_serve_stage_seconds_count{{stage="{stage}"}}',
                       0.0)
        s = series.get(f'pio_serve_stage_seconds_sum{{stage="{stage}"}}',
                       0.0)
        out[stage] = {"count": int(n), "sum_s": s,
                      "mean_ms": 1e3 * s / n if n else None}
    return out


def phase_wire(torch, ft, dev, rng, model, card: str) -> dict:
    """Phase 4's model behind the serve plane, its clients in separate
    processes: the same WIRE_PLAIN + WIRE_BANNED + WIRE_BIN requests over
    the selector wire, again over the selector wire with its request
    log at INFO (a default deploy's level; the run's own level is
    WARNING), then over the threaded one; then a shed run on the
    selector wire at max_inflight SHED_INFLIGHT with a quarter of its
    requests carrying an unmeetable deadline. The selector pass's server
    then takes phase obs's traced pass (`obs_pass`; its result under
    "obs" of the returned dict, not in the phase line)."""
    from predictionio_tpu_torch.utils.wire import reactor_count
    t_phase = time.perf_counter()
    reqs = wire_requests(torch, ft, dev, rng, model, WIRE_PLAIN,
                         WIRE_BANNED, WIRE_BIN)
    obs_reqs = wire_requests(torch, ft, dev, rng, model, OBS_PLAIN,
                             OBS_BANNED, OBS_BIN)
    obs = quality = None
    out = {"phase": "wire", "card": card, "users": N_USERS,
           "items": N_ITEMS, "rank": RANK, "k": K, "banned_width": WIDTH,
           "client_processes": WIRE_PROCS, "connections": WIRE_PROCS
           * WIRE_CONNS, "host_cpus": os.cpu_count(),
           "reactors": reactor_count(), "wires": {}}
    launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_wire_") as tmp:
        tmp = Path(tmp)
        for name, wire in (("selector", "selector"),
                           ("selector_info_log", "selector"),
                           ("threaded", "threaded")):
            log_file = tmp / "wire_info.log" if name.endswith("_log") \
                else None
            run = wire_run(torch, ft, dev, model, reqs, tmp, wire,
                           log_file=log_file,
                           obs_reqs=obs_reqs if name == "selector" else None)
            obs = obs or run["obs"]
            quality = quality or run["quality"]
            res = run["res"]
            codes = sorted({r[0] for r in res})
            if codes != [200]:
                fail(f"wire {wire}: statuses {codes}")
            err = check_wire_answers(torch, ft, dev, model, reqs, res, wire)
            series = run["series"]
            counted = prom_sum(series, 'pio_http_requests_total{route='
                               '"/queries.json"')
            if counted != len(reqs):
                fail(f"wire {wire}: /metrics counts {counted} queries of "
                     f"{len(reqs)} sent")
            log_lines = None
            if log_file is not None:
                # one "request" line per generic-route request (the fast
                # route writes none, as in the JAX package)
                log_lines = sum(
                    1 for line in log_file.read_text().splitlines()
                    if json.loads(line).get("event") == "request")
                want = sum(1 for r in reqs if r["kind"] == "banned")
                if log_lines < want:
                    fail(f"wire {name}: {log_lines} request log lines, "
                         f"{want} generic-route requests sent")
            launches += run["launches"]
            out["wires"][name] = {
                "wire": wire, "request_log_lines": log_lines,
                "requests": len(reqs), "answers_checked": len(reqs),
                "max_abs_err": err, "metrics_requests": counted,
                "launches": run["launches"],
                "plan_calls": run["plan_calls"],
                "expected_calls": run["expected_calls"],
                "warmed_buckets": run["buckets"],
                "drained_batches": sum(run["sizes"].values()),
                "batch_sizes": {str(n): c for n, c in
                                sorted(run["sizes"].items())},
                "wall_s": run["wall_s"],
                "all": lat_summary(res, range(len(res))),
                "by_route": {kind: lat_summary(res, [
                    i for i, r in enumerate(reqs) if r["kind"] == kind])
                    for kind in ("plain", "banned", "binary")},
                "predict_batch_s": sum(run["batch_s"]),
                "predict_batch_share_of_wall": sum(run["batch_s"])
                / run["wall_s"],
                "stage_seconds": stage_split(series),
                "wire_requests": prom_sum(series,
                                          "pio_wire_requests_total{")}
        # the shed run: admission at SHED_INFLIGHT, unmeetable deadlines
        shed = wire_requests(torch, ft, dev, rng, model, SHED_REQUESTS,
                             0, 0)
        for n, r in enumerate(shed):
            if n % 4 == 3:
                r["deadline"] = SHED_DEADLINE_MS
        run = wire_run(torch, ft, dev, model, shed, tmp, "selector",
                       max_inflight=SHED_INFLIGHT)
        res, series = run["res"], run["series"]
        launches += run["launches"]
        by = {c: [i for i, r in enumerate(res) if r[0] == c]
              for c in (200, 503, 504)}
        other = sorted({r[0] for r in res} - set(by))
        if other or not by[503] or not by[504]:
            fail(f"shed run: statuses {sorted({r[0] for r in res})}, "
                 f"{len(by[503])} x 503, {len(by[504])} x 504")
        if any(not res[i][1] or int(res[i][1]) < 1 for i in by[503]):
            fail("shed run: a 503 without Retry-After")
        if any("deadline" not in shed[i] for i in by[504]):
            fail("shed run: a 504 for a request with no deadline")
        err = check_wire_answers(torch, ft, dev, model, shed, res, "shed")
        counted = {c: prom_sum(series, "pio_http_requests_total{",
                               f'status="{c}"}}') for c in by}
        shed_total = prom_sum(series, "pio_shed_total{")
        deadline_batch = prom_sum(series, 'pio_shed_total{surface='
                                  '"deadline_batch"')
        expired = prom_sum(series, "pio_deadline_expired_total{")
        if counted != {c: float(len(v)) for c, v in by.items()} \
                or shed_total - deadline_batch != len(by[503]) \
                or expired != len(by[504]):
            fail(f"shed run: /metrics counts {counted}, shed "
                 f"{shed_total} (deadline_batch {deadline_batch}), "
                 f"expired {expired}; clients saw "
                 f"{ {c: len(v) for c, v in by.items()} }")
        out["shed"] = {
            "requests": len(shed), "max_inflight": SHED_INFLIGHT,
            "deadline_ms": float(SHED_DEADLINE_MS),
            "deadlined": sum(1 for r in shed if "deadline" in r),
            "status_counts": {str(c): len(v) for c, v in by.items()},
            "metrics_status_counts": {str(c): v for c, v in counted.items()},
            "shed_by_surface": {
                k.split('surface="')[1].split('"')[0]: v
                for k, v in series.items() if k.startswith(
                    "pio_shed_total{")},
            "deadline_expired": expired, "answers_checked": len(by[200]),
            "max_abs_err": err, "launches": run["launches"],
            "plan_calls": run["plan_calls"],
            "ok_latency": lat_summary(res, by[200])}
    out["launches"] = launches
    out["max_abs_err"] = max(w["max_abs_err"]
                             for w in out["wires"].values())
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return {**out, "obs": obs, "quality": quality}


# -- phase fleet: serving across processes and tenancy ------------------------
FLEET_SHARDS = 3          # (a) --replicas 3 --mesh items=3@fleet
MESH_REQUESTS = 1_280     # (a) half of phase wire's mix: the script's time
ROLL_REPLICAS = 2         # (b) whole-catalog replicas rolled under load
SUPERVISED = 2            # (c) --supervised 2, the whole catalog each
TENANT_REQUESTS = 1_280   # (d) half per app
FLOOD_RATE = 50.0         # (d) the over-quota app's rate and burst
FLEET_KEY = "fleet-server-key"
LOOP_PAD_S = 0.5          # load before a roll or a kill, and after it
QUALITY_TRACE_SAMPLE = 0.05   # (b), (c): kept traces for the canary

# a client process that cycles through its requests over kept-alive
# connections until its stop file appears; every answer is recorded
FLEET_LOOP_CLIENT = r"""
import http.client, json, os, sys, threading, time
reqfile, outfile, host, port, conns, stopfile = sys.argv[1:7]
port, conns = int(port), int(conns)
reqs = json.load(open(reqfile))
pool = [http.client.HTTPConnection(host, port, timeout=120)
        for _ in range(conns)]
for c in pool:
    c.connect()
print("ready", flush=True)
sys.stdin.readline()
outs = [[] for _ in range(conns)]

def run(w):
    conn, n, out = pool[w], w, outs[w]
    while not os.path.exists(stopfile):
        r = reqs[n % len(reqs)]
        n += conns
        body = (bytes.fromhex(r["body"]) if r["bin"]
                else r["body"].encode())
        hdrs = {"Content-Type": ("application/x-pio-bin" if r["bin"]
                                 else "application/json")}
        t0 = time.monotonic()
        try:
            conn.request("POST", "/queries.json", body, hdrs)
            resp = conn.getresponse()
            out.append([r["i"], resp.status, resp.read().decode(), t0,
                        time.monotonic()])
        except Exception as e:
            out.append([r["i"], -1, repr(e), t0, time.monotonic()])
            conn.close()
            conn = http.client.HTTPConnection(host, port, timeout=120)

threads = [threading.Thread(target=run, args=(w,)) for w in range(conns)]
for t in threads:
    t.start()
for t in threads:
    t.join()
json.dump([x for o in outs for x in o], open(outfile, "w"))
"""


class FleetLoad:
    """WIRE_PROCS FLEET_LOOP_CLIENT processes of WIRE_CONNS connections
    each, cycling through `reqs` (each with its index "i") against
    `port` from `start()` until `stop()`, which returns [index, status,
    body, t_send, t_recv] per answer (CLOCK_MONOTONIC)."""

    def __init__(self, port: int, reqs: list, tmp: Path, name: str):
        self.stop_file = tmp / f"{name}.stop"
        self.procs, self.outs = [], []
        for p in range(WIRE_PROCS):
            req_f = tmp / f"{name}_req_{p}.json"
            out_f = tmp / f"{name}_out_{p}.json"
            req_f.write_text(json.dumps(
                [{k: r[k] for k in ("body", "bin", "i")}
                 for r in reqs[p::WIRE_PROCS]]))
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", FLEET_LOOP_CLIENT, str(req_f),
                 str(out_f), "127.0.0.1", str(port), str(WIRE_CONNS),
                 str(self.stop_file)], stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, text=True))
            self.outs.append(out_f)

    def start(self) -> "FleetLoad":
        for proc in self.procs:
            if proc.stdout.readline().strip() != "ready":
                self.kill()
                fail("a fleet load client did not come up")
        for proc in self.procs:
            proc.stdin.write("go\n")
            proc.stdin.flush()
        return self

    def kill(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def stop(self) -> list:
        self.stop_file.touch()
        try:
            for proc in self.procs:
                if proc.wait(timeout=300) != 0:
                    fail(f"a fleet load client exited {proc.returncode}")
        finally:
            self.kill()
        return [r for out_f in self.outs
                for r in json.loads(out_f.read_text())]


def fleet_instance(registry, model, app_name: Optional[str] = None) -> str:
    """Record `model` as a COMPLETED instance of the recommendation
    template in `registry` (blob and row as `cli train` writes them),
    through `CoreWorkflow.run_train` with an algorithm that hands the
    model over; returns its id. `app_name` names the data source's app
    in the instance (what a refresher reads), else it names none."""
    from predictionio_tpu_torch.core.base import (DataSource, FirstServing,
                                                  IdentityPreparator)
    from predictionio_tpu_torch.core.engine import Engine
    from predictionio_tpu_torch.core.runtime import (RuntimeContext,
                                                     WorkflowParams)
    from predictionio_tpu_torch.core.workflow import CoreWorkflow
    from predictionio_tpu_torch.models.recommendation import ALSAlgorithm

    class GivenModel(ALSAlgorithm):
        def train(self, ctx, pd):
            return model

    class NoEvents(DataSource):
        def read_training(self, ctx):
            return None

    variant = {"algorithms": [{"name": "als", "params": {}}]}
    if app_name is not None:
        from predictionio_tpu_torch.models.recommendation import \
            DataSourceParams
        NoEvents.params_class = DataSourceParams
        variant["datasource"] = {"params": {"app_name": app_name}}
    engine = Engine(NoEvents, IdentityPreparator, {"als": GivenModel},
                    FirstServing)
    row = CoreWorkflow.run_train(
        engine, engine.engine_params_from_variant(variant),
        RuntimeContext(registry=registry, device=model.device,
                       workflow_params=WorkflowParams(
                           skip_sanity_check=True)),
        engine_factory="recommendation", engine_variant="default")
    return row.id


def k1_answers(torch, ft, dev, model, queries) -> list:
    """Single-device K1 over `model`'s whole catalog for each query, as
    the served answer lists it: [(item names, float32 scores)], cut to
    `num` and the real candidates."""
    from predictionio_tpu_torch.ops.topk import NEG_INF
    n_items = model.item_factors.shape[0]
    items = model.item_factors.to(dev)
    out = []
    for lo in range(0, len(queries), 64):
        part = queries[lo:lo + 64]
        rows = torch.tensor([model.users(q["user"]) for q in part],
                            device=dev)
        banned = np.full((len(part), WIDTH), n_items, np.int32)
        for r, q in enumerate(part):
            ids = [model.items(x) for x in q.get("blackList", ())]
            banned[r, :len(ids)] = ids
        sc, ix = ft.fused_topk(model.user_factors[rows], items,
                               torch.from_numpy(banned).to(dev), k=K,
                               n_valid=n_items)
        sc, ix = sc.cpu().numpy(), ix.cpu().numpy()
        for r, q in enumerate(part):
            keep = [c for c in range(K) if sc[r, c] > NEG_INF / 2][:q["num"]]
            out.append(([model.items.inverse(int(ix[r, c])) for c in keep],
                        [float(sc[r, c]) for c in keep]))
    return out


def match_tables(what: str, bodies: list, idx: list, tables: list) -> list:
    """For each served body (of request `idx[n]`), the index of the K1
    answer table it equals bit for bit (names and float32 scores); fails
    on a body equal to none of them."""
    out = []
    for n, body in enumerate(bodies):
        got = json.loads(body)
        if "partial" in got:
            fail(f"{what}: a partial answer {body[:200]}")
        names = [g["item"] for g in got["itemScores"]]
        scores = np.float32([g["score"] for g in got["itemScores"]])
        hit = [t for t, table in enumerate(tables)
               if table[idx[n]][0] == names and np.array_equal(
                   np.float32(table[idx[n]][1]), scores)]
        if not hit:
            fail(f"{what}: request {idx[n]} answered {body[:300]}, no "
                 "table's single-device K1 answer")
        out.append(hit[0])
    return out


def member_calls(server) -> dict:
    """An in-process replica's plan calls against its warmed buckets and
    drained chunks."""
    plan = server.deployment.algos[0]._serve_plan
    sizes = server.batcher.batch_sizes()
    expected = len(plan.buckets) + sum(c * -(-n // plan.max_bucket)
                                       for n, c in sizes.items())
    return {"shard": server.shard_spec(), "plan": type(plan).__name__,
            "slice_items": getattr(plan, "slice_items", None),
            "plan_calls": plan.calls, "expected_calls": expected,
            "requests": sum(n * c for n, c in sizes.items()),
            "drained_batches": sum(sizes.values()),
            "warmed_buckets": len(plan.buckets)}


def canary_gates(fleet, old_plans) -> dict:
    """Phase quality (b), after fleet (b)'s roll: each in-process
    replica's canary ran report-only and passed (one
    `pio_canary_total{outcome="pass"}` per replica in the replicas'
    registries, at least one replayed query each); each replica's old
    and new plans' calls = both plans' warmed buckets + the drained
    chunks across the roll + one call per plan per 64 replayed
    queries."""
    out = []
    registries = {}
    for rep, old in zip(fleet.replicas(), old_plans):
        srv = rep.server
        registries[id(srv.metrics)] = srv.metrics
        new = srv.deployment.algos[0]._serve_plan
        last = srv.quality_snapshot().get("canary") or {}
        sampled = last.get("sampled", 0)
        replays = 2 * -(-sampled // new.max_bucket)
        want = len(old.buckets) + len(new.buckets) + chunks(
            srv.batcher.batch_sizes(), new.max_bucket) + replays
        if last.get("outcome") != "pass" or sampled < 1 \
                or old.calls + new.calls != want:
            fail(f"quality (b): replica {rep.key}'s canary {last}; plan "
                 f"calls {old.calls} + {new.calls}, expected {want} "
                 "(warmup + drained chunks + replays)")
        out.append({"member": rep.key, "sampled": sampled,
                    "overlap": last["overlap"],
                    "score_delta": last["score_delta"],
                    "replay_calls": replays,
                    "plan_calls": old.calls + new.calls})
    passes = sum(m.value("pio_canary_total", outcome="pass") or 0
                 for m in registries.values())
    if passes != len(out):
        fail(f"quality (b): {passes} canary passes counted for "
             f"{len(out)} replicas")
    return {"replicas": out, "canary_pass_total": passes}


def canary_veto(torch, ft, dev, engine, ctx, instances, iid, reqs, tables,
                tmp: Path) -> dict:
    """Phase quality (c): instance `iid` (the first table) served in this
    process with `canary_min_overlap` 0.5 (`deploy --canary-min-overlap
    0.5`) under looping clients, then /reload, whose latest instance is
    the second table, sharing none of the answers: the canary refuses it
    (`CanaryVeto`, a 500 naming the overlap), the server keeps serving
    `iid`, no request fails and every answer before and after is the
    first table's. K1 launches = plan calls: the served plan's warmed
    buckets + drained chunks + its replay, and the refused plan's warmed
    buckets + its replay."""
    from predictionio_tpu_torch.cli.main import deploy_instance
    from predictionio_tpu_torch.obs import MetricsRegistry
    from predictionio_tpu_torch.ops import topk
    t_part = time.perf_counter()
    ft.LAUNCHES = 0
    topk.PLAN_CALLS = 0
    server = deploy_instance(engine, instances.get(iid), ctx, port=0,
                             batch_max=64, server_key=FLEET_KEY,
                             canary_min_overlap=0.5,
                             metrics=MetricsRegistry())
    try:
        plan = server.deployment.algos[0]._serve_plan
        load = FleetLoad(server.port, reqs, tmp, "veto").start()
        try:
            time.sleep(LOOP_PAD_S)
            t0 = time.monotonic()
            try:
                post_reload(server.port, FLEET_KEY)
                code, message = 200, ""
            except urllib.error.HTTPError as e:
                code, message = e.code, json.loads(e.read())["message"]
            reload_s = time.monotonic() - t0
            time.sleep(LOOP_PAD_S)
        finally:
            res = load.stop()
        serving = server.deployment.instance_id
        last = server.quality_snapshot()["canary"] or {}
        fails = server.metrics.value("pio_canary_total", outcome="fail")
        sampled = last.get("sampled", 0)
        replay = -(-sampled // plan.max_bucket)
        want = len(plan.buckets) + chunks(server.batcher.batch_sizes(),
                                          plan.max_bucket) + replay
        launches, calls = ft.LAUNCHES, topk.PLAN_CALLS
    finally:
        server.stop()
    if code != 500 or "CanaryVeto" not in message or serving != iid or \
            last.get("outcome") != "fail" or fails != 1 or sampled < 1:
        fail(f"quality (c): /reload answered {code} {message!r}, serving "
             f"{serving}, canary {last}, {fails} vetoes")
    bad = [r for r in res if r[1] != 200]
    if bad:
        fail(f"quality (c): {len(bad)} of {len(res)} requests failed: "
             f"{bad[0][:3]}")
    which = match_tables("quality (c)", [r[2] for r in res],
                         [r[0] for r in res], tables)
    if set(which) != {0}:
        fail(f"quality (c): answers from tables {sorted(set(which))}")
    if not (launches == calls and plan.calls == want
            and launches - plan.calls == len(plan.buckets) + replay):
        fail(f"quality (c): K1 launches {launches}, plan calls {calls}; "
             f"the served plan's {plan.calls} (expected {want})")
    return {"requests": len(res), "failed": 0, "old_table_answers": len(res),
            "reload_status": code, "message": message,
            "overlap": last["overlap"], "min_overlap": last["min_overlap"],
            "sampled": sampled, "reload_s": reload_s,
            "launches": launches, "plan_calls": calls,
            "all": lat_summary(res, range(len(res))),
            "seconds": time.perf_counter() - t_part}


def post_reload(port: int, key: str) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/reload", data=b"", method="POST",
        headers={"Authorization": "Basic " + base64.b64encode(
            f"{key}:".encode()).decode()})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def fleet_stitch(port: int, reqs: list, member_ports: list,
                 table: list) -> dict:
    """Phase obs (b) through a supervised fleet traced at
    OBS_TRACE_SAMPLE: OBS_STITCHED requests of phase wire's mix, each
    with its own trace id in an `X-PIO-Trace` signed with the fleet's
    key and marked sampled. Gates: every answer the single-device K1
    answer of `table`; each trace id in the router's ring as one
    `kind="router"` entry under the sent span with a `proxy:` span, and
    in exactly one child's `/traces.json` as one `kind="serve"` entry
    under the router's span."""
    import http.client
    from predictionio_tpu_torch.obs import trace
    t0 = time.perf_counter()
    sent, bodies = [], []
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        for r in reqs[:OBS_STITCHED]:
            tid, sid = os.urandom(16).hex(), os.urandom(8).hex()
            conn.request(
                "POST", "/queries.json",
                bytes.fromhex(r["body"]) if r["bin"] else r["body"].encode(),
                {"Content-Type": ("application/x-pio-bin" if r["bin"]
                                  else "application/json"),
                 trace.TRACE_HEADER: trace.encode_header(
                     tid, sid, True, key=FLEET_KEY)})
            resp = conn.getresponse()
            data = resp.read().decode()
            if resp.status != 200:
                fail(f"obs (b): a traced request answered {resp.status}: "
                     f"{data[:300]}")
            sent.append((tid, sid))
            bodies.append(data)
    finally:
        conn.close()
    match_tables("obs (b)", bodies, [r["i"] for r in reqs[:OBS_STITCHED]],
                 [table])

    def problems():
        out = []
        for tid, sid in sent:
            hops = http_json(port, f"/traces.json?trace_id={tid}")[1][
                "traces"]
            if len(hops) != 1 or hops[0]["kind"] != "router" or \
                    hops[0]["parent_id"] != sid or not any(
                        sp["name"].startswith("proxy:")
                        for sp in hops[0]["spans"]):
                out.append((tid, "router", hops))
                continue
            serve = [e for mp in member_ports
                     for e in http_json(mp, f"/traces.json?trace_id={tid}")[
                         1]["traces"]]
            if len(serve) != 1 or serve[0]["kind"] != "serve" or \
                    serve[0]["parent_id"] != hops[0]["span_id"]:
                out.append((tid, "children", serve))
        return out

    end = time.monotonic() + 30
    while True:
        bad = problems()
        if not bad or time.monotonic() > end:
            break
        time.sleep(0.2)
    if bad:
        fail(f"obs (b): {len(bad)} of {len(sent)} trace ids not stitched: "
             f"{bad[0]}")
    return {"requests": len(sent), "stitched": len(sent),
            "members": len(member_ports),
            "seconds": time.perf_counter() - t0}


def proc_start_boottime(pid: int) -> Optional[float]:
    """A process's start on CLOCK_BOOTTIME, from /proc (None off Linux)."""
    try:
        fields = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1]
        ticks = int(fields.split()[19])
    except (OSError, IndexError, ValueError):
        return None
    return ticks / os.sysconf("SC_CLK_TCK")


def read_counts(port: int):
    """One read of a child's GET / counts, and whether they agree: K1
    launches = plan calls = warmed buckets + drained chunks, no K2
    launch."""
    st = http_status(port)
    sizes = {int(k): v for k, v in st["batch_sizes"].items()}
    buckets, = st["plan_buckets"]
    expected = len(buckets) + sum(
        c * -(-n // max(buckets)) for n, c in sizes.items())
    k1 = st["kernel_launches"]["fused_topk"]
    k2 = st["kernel_launches"]["shard_local_candidates"]
    return {"pid": st["pid"], "launches": k1, "plan_calls": st["plan_calls"],
            "expected_calls": expected, "k2_launches": k2,
            "requests": sum(n * c for n, c in sizes.items()),
            "deploy_timings": st["deploy_timings"]}, (
        k1 == st["plan_calls"] == expected and not k2)


def child_counts(m, what, settle_s=0.0):
    """A child's GET / counts (`read_counts`). Under load a read can
    fall inside a batch (its size counted, its plan call or launch not
    yet), so it is read again for up to `settle_s` until the three agree
    between batches."""
    end = time.monotonic() + settle_s
    while True:
        counts, ok = read_counts(m["port"])
        if ok:
            break
        if time.monotonic() >= end:
            fail(f"supervised child {m['name']} ({what}): K1 launches "
                 f"{counts['launches']}, plan calls {counts['plan_calls']}, "
                 f"expected {counts['expected_calls']}, K2 "
                 f"{counts['k2_launches']}")
        time.sleep(0.005)
    del counts["k2_launches"]
    return {"name": m["name"], **counts}


def wire_reference(torch, ft, dev, rng, model) -> dict:
    """`--only fleet`'s stand-in for phase wire's selector pass: the same
    request mix served by one process on the selector wire, checked."""
    reqs = wire_requests(torch, ft, dev, rng, model, WIRE_PLAIN,
                         WIRE_BANNED, WIRE_BIN)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_wire_") as tmp:
        run = wire_run(torch, ft, dev, model, reqs, Path(tmp), "selector")
    res = run["res"]
    if sorted({r[0] for r in res}) != [200]:
        fail(f"wire reference: statuses {sorted({r[0] for r in res})}")
    check_wire_answers(torch, ft, dev, model, reqs, res, "wire reference")
    return lat_summary(res, range(len(res)))


def phase_fleet(torch, ft, dev, rng, model, card: str,
                wire_ref: dict) -> dict:
    """Phase 4's model written once into a SQLITE store as a COMPLETED
    instance, served by fleets of the port's own processes, 4 client
    processes x 16 kept-alive connections with phase wire's request mix,
    every answer held bit for bit to the single-device K1 answer of its
    table (and those to the plain version): (a) a router over 3
    in-process replicas serving catalog slices (`items=3@fleet`); (b) a
    rolling /reload of 2 whole-catalog replicas to a second instance
    with a new item table, under load; (c) `cli deploy --supervised 2`
    in a subprocess, one child SIGKILLed under load and respawned; (d)
    tenancy at the router, one app past its rate quota."""
    import signal
    from predictionio_tpu_torch.cli import ops as cli_ops
    from predictionio_tpu_torch.cli.main import fleet_replica_factory
    from predictionio_tpu_torch.core.runtime import RuntimeContext
    from predictionio_tpu_torch.core.workflow import resolve_engine
    from predictionio_tpu_torch.data.storage import StorageRegistry
    from predictionio_tpu_torch.obs import MetricsRegistry, trace
    from predictionio_tpu_torch.ops import topk
    from predictionio_tpu_torch.ops.als import als_model_from_numpy
    from predictionio_tpu_torch.serving.fleet import FleetConfig, FleetServer
    from predictionio_tpu_torch.tenancy import TenancyConfig
    t_phase = time.perf_counter()
    reqs = wire_requests(torch, ft, dev, rng, model, WIRE_PLAIN,
                         WIRE_BANNED, WIRE_BIN)
    for n, r in enumerate(reqs):
        r["i"] = n
    queries = [r["query"] for r in reqs]
    model2 = als_model_from_numpy(
        model.user_factors.cpu().numpy(),
        rng.standard_normal((N_ITEMS, RANK), dtype=np.float32) / 8.0,
        [f"u{n}" for n in range(N_USERS)], [f"i{n}" for n in range(N_ITEMS)],
        device=dev)
    # the answer tables: K1 on one card over each whole catalog, held to
    # the plain version (these launches come before any count is reset)
    tables = [k1_answers(torch, ft, dev, m, queries) for m in (model, model2)]
    table_err = [check_answers(torch, ft, dev, m, queries, [
        [{"item": a, "score": b} for a, b in zip(*row)] for row in table])
        for m, table in zip((model, model2), tables)]
    out = {"phase": "fleet", "card": card, "users": N_USERS,
           "items": N_ITEMS, "rank": RANK, "k": K, "requests": len(reqs),
           "client_processes": WIRE_PROCS,
           "connections": WIRE_PROCS * WIRE_CONNS,
           "table_max_abs_err": max(table_err),
           "wire_selector_direct": wire_ref}
    launches = 0
    engine = resolve_engine("recommendation")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
        tmp = Path(tmp)
        config = {"PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
                  "PIO_STORAGE_SOURCES_DB_PATH": str(tmp / "pio.db")}
        registry = StorageRegistry(config)
        t0 = time.perf_counter()
        iid1 = fleet_instance(registry, model)
        out["store_instance_s"] = time.perf_counter() - t0
        instances = registry.get_meta_data_engine_instances()
        ctx = RuntimeContext(registry=registry, device=dev)

        def factory(iid, **kw):
            return fleet_replica_factory(
                engine, instances.get(iid), ctx, batch_max=64,
                server_key=FLEET_KEY, metrics=MetricsRegistry(), **kw)

        def start_fleet(iid, replicas, mesh="", tenancy=None,
                        metrics=None):
            ft.LAUNCHES = 0          # the counts cover this part only
            ft.SHARD_LAUNCHES = 0
            topk.PLAN_CALLS = 0
            t = time.perf_counter()
            fleet = FleetServer(
                factory(iid), fleet=FleetConfig(replicas=replicas),
                port=0, registry=registry, mesh=mesh, server_key=FLEET_KEY,
                tenancy=tenancy or TenancyConfig(),
                metrics=metrics or MetricsRegistry())
            fleet.start()
            return fleet, time.perf_counter() - t

        def gate_inprocess(what, fleet, per_member=True):
            """K1 launches = the plan calls of every plan of the part
            (this process's replicas share the counter); per member,
            plan calls = warmed buckets + drained chunks (not across a
            reload, whose new plan starts its own count)."""
            # (remote members restored from the store's member snapshot
            # of an earlier part are no in-process replicas)
            members = [member_calls(rep.server) for rep in fleet.replicas()
                       if rep.server is not None]
            for m in members:
                if per_member and m["plan_calls"] != m["expected_calls"]:
                    fail(f"{what}: a member's plan calls {m}")
            if not ft.LAUNCHES == topk.PLAN_CALLS or (per_member and (
                    ft.LAUNCHES != sum(m["plan_calls"] for m in members))):
                fail(f"{what}: K1 launches {ft.LAUNCHES}, plan calls "
                     f"{topk.PLAN_CALLS} across its plans, members "
                     f"{members}")
            if ft.SHARD_LAUNCHES:
                fail(f"{what}: {ft.SHARD_LAUNCHES} K2 launches")
            return members, ft.LAUNCHES

        # (a) the catalog mesh
        mreqs = reqs[:MESH_REQUESTS]
        fleet, start_s = start_fleet(iid1, FLEET_SHARDS,
                                     mesh=f"items={FLEET_SHARDS}@fleet")
        try:
            res = wire_clients(fleet.port, mreqs, tmp)
            members, n_launch = gate_inprocess("fleet mesh", fleet)
            routed = fleet.status_json()
        finally:
            fleet.stop()
        codes = sorted({r[0] for r in res})
        if codes != [200]:
            fail(f"fleet mesh: statuses {codes}")
        match_tables("fleet mesh", [r[2] for r in res], range(len(res)),
                     tables[:1])
        if sorted(m["shard"] for m in members) != [
                f"{i}/{FLEET_SHARDS}" for i in range(FLEET_SHARDS)] or any(
                m["plan"] != "ShardSliceTopK" or m["requests"] != len(mreqs)
                for m in members):
            fail(f"fleet mesh: members {members}")
        launches += n_launch
        out["mesh"] = {
            "replicas": FLEET_SHARDS, "start_s": start_s,
            "members": members, "launches": n_launch,
            "k2_launches": 0, "answers_bit_identical": len(res),
            "admitted": sum(1 for m in routed["replicas"] if m["admitted"]),
            "all": lat_summary(res, range(len(res))),
            "by_route": {kind: lat_summary(res, [
                i for i, r in enumerate(mreqs) if r["kind"] == kind])
                for kind in ("plain", "banned", "binary")}}

        # (b) a rolling /reload to a new item table under load; phase
        # quality (b): each replica's canary replays kept serve traces
        # (sampled at QUALITY_TRACE_SAMPLE) through both plans, report-only
        iid2 = fleet_instance(registry, model2)
        trace.configure(sample=QUALITY_TRACE_SAMPLE)
        fleet, start_s = start_fleet(iid1, ROLL_REPLICAS)
        try:
            old_plans = [rep.server.deployment.algos[0]._serve_plan
                         for rep in fleet.replicas()]
            load = FleetLoad(fleet.port, reqs, tmp, "roll").start()
            try:
                time.sleep(LOOP_PAD_S)
                t_roll0 = time.monotonic()
                report = post_reload(fleet.port, FLEET_KEY)
                t_roll1 = time.monotonic()
                time.sleep(LOOP_PAD_S)
            finally:
                res = load.stop()
            serving = [rep.server.deployment.instance_id
                       for rep in fleet.replicas()]
            members, n_launch = gate_inprocess("rolling reload", fleet,
                                               per_member=False)
            canary_b = canary_gates(fleet, old_plans)
        finally:
            fleet.stop()
        if report["aborted"] or [r["outcome"] for r in report["results"]] \
                != ["reloaded"] * ROLL_REPLICAS or serving != \
                [iid2] * ROLL_REPLICAS:
            fail(f"rolling reload: {report}, serving {serving}")
        bad = [r for r in res if r[1] != 200]
        if bad:
            fail(f"rolling reload: {len(bad)} of {len(res)} requests "
                 f"failed: {bad[0][:3]}")
        which = match_tables("rolling reload", [r[2] for r in res],
                             [r[0] for r in res], tables)
        after = [w for r, w in zip(res, which) if r[3] > t_roll1]
        if not after or set(after) != {1}:
            fail(f"rolling reload: {len(after)} answers after the roll, "
                 f"tables {sorted(set(after))}")
        launches += n_launch
        out["roll"] = {
            "replicas": ROLL_REPLICAS, "start_s": start_s,
            "roll_s": t_roll1 - t_roll0, "report": report,
            "requests": len(res), "failed": 0,
            "old_table_answers": which.count(0),
            "new_table_answers": which.count(1),
            "answers_after_roll": len(after), "launches": n_launch,
            "plan_calls": topk.PLAN_CALLS, "k2_launches": 0,
            "all": lat_summary(res, range(len(res))),
            "during_roll": lat_summary(res, [
                n for n, r in enumerate(res) if t_roll0 <= r[3] <= t_roll1])}

        # phase quality (c): a reload refused by the canary
        try:
            veto = canary_veto(torch, ft, dev, engine, ctx, instances, iid1,
                               reqs, tables, tmp)
        finally:
            trace.configure(sample=0.0)
        out["quality_bc"] = {"b": canary_b, "c": veto}

        # (c) --supervised 2 as a subprocess: a child killed under load
        lib = ft.build_library()
        lib_mtime = lib.stat().st_mtime_ns
        cli = cli_runner(tmp, {**config, "PIO_FLEET_HEARTBEAT_S": "0.5",
                               "PIO_TRACE_SAMPLE": OBS_TRACE_SAMPLE})
        t0 = time.perf_counter()
        proc, line = start_server(
            tmp, cli, "deploy", "--supervised", str(SUPERVISED),
            "--engine-instance-id", iid1, "--port", "0", "--batch-max",
            "64", "--server-key", FLEET_KEY)
        if not line.startswith("Fleet control plane started on"):
            proc.kill()
            fail(f"supervised deploy: {line!r} {stderr_tail(proc)}")
        port = int(line.split(" on ")[1].split()[0].rsplit(":", 1)[1])

        def admitted():
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/status.json",
                    timeout=60) as resp:
                return [m for m in json.loads(resp.read())["replicas"]
                        if m["admitted"]]

        def wait_members(pred, what, timeout_s=300.0):
            end = time.monotonic() + timeout_s
            while time.monotonic() < end:
                if proc.poll() is not None:
                    fail(f"supervised deploy exited {proc.returncode}: "
                         f"{stderr_tail(proc)}")
                got = admitted()
                if pred(got):
                    return got
                time.sleep(0.05)
            fail(f"supervised deploy: timed out waiting for {what}")

        try:
            first = wait_members(lambda m: len(m) == SUPERVISED,
                                 "both children")
            ready_s = time.perf_counter() - t0
            victim = first[0]
            pid = http_status(victim["port"])["pid"]
            load = FleetLoad(port, reqs, tmp, "kill").start()
            try:
                time.sleep(LOOP_PAD_S)
                # the victim's counts, read just before the kill: the
                # batches it drains between this read and the kill are
                # counted nowhere
                killed = {**child_counts(victim, "read before its kill",
                                         settle_s=10.0),
                          "killed": True, "respawned": False}
                t_kill = time.monotonic()
                os.kill(pid, signal.SIGKILL)
                back = wait_members(lambda m: any(
                    x["name"] == victim["name"]
                    and x["member"] != victim["member"] for x in m)
                    and len(m) == SUPERVISED, "the respawned child")
                t_back = time.monotonic()
                boot_back = time.clock_gettime(time.CLOCK_BOOTTIME)
                time.sleep(LOOP_PAD_S)
            finally:
                res = load.stop()
            reborn = next(x for x in back if x["name"] == victim["name"])
            new_pid = http_status(reborn["port"])["pid"]
            started = proc_start_boottime(new_pid)
            children = [killed] + [
                {**child_counts(m, "after the load"), "killed": False,
                 "respawned": m is reborn} for m in back]
            # phase obs (b), after the children's counts were read
            stitched = fleet_stitch(port, reqs, [m["port"] for m in back],
                                    tables[0])
        finally:
            stop_deploy(proc, "supervised deploy")
        bad = [r for r in res if r[1] != 200]
        if bad:
            fail(f"supervised kill: {len(bad)} of {len(res)} requests "
                 f"failed: {bad[0][:3]}")
        match_tables("supervised kill", [r[2] for r in res],
                     [r[0] for r in res], tables[:1])
        if lib.stat().st_mtime_ns != lib_mtime:
            fail("a supervised child rebuilt the kernel library")
        n_launch = sum(c["launches"] for c in children)
        launches += n_launch
        out["supervised"] = {
            "children": SUPERVISED, "ready_s": ready_s,
            "requests": len(res), "failed": 0,
            "kill_to_admitted_s": t_back - t_kill,
            "respawn_to_admitted_s": (boot_back - started
                                      if started is not None else None),
            "members": children, "launches": n_launch,
            "library_rebuilt_by_a_child": False, "obs_b": stitched,
            "all": lat_summary(res, range(len(res))),
            "after_kill": lat_summary(res, [
                n for n, r in enumerate(res) if r[3] >= t_kill])}

        # (d) tenancy at the router: one app past its rate quota
        keys = {name: cli_ops.app_new(registry, name)["accessKey"]
                for name in ("calm", "flood")}
        cli_ops.app_quota_set(registry, "flood", rate=FLOOD_RATE,
                              burst=FLOOD_RATE)
        treqs = []
        for n, r in enumerate(reqs[:TENANT_REQUESTS]):
            app = ("calm", "flood")[n % 2]
            treqs.append({**r, "app": app,
                          "path": f"/queries.json?accessKey={keys[app]}"})
        router_metrics = MetricsRegistry()
        fleet, start_s = start_fleet(
            iid1, 1, tenancy=TenancyConfig(enabled=True, rate=1e6,
                                           burst=1e6),
            metrics=router_metrics)
        try:
            res = wire_clients(fleet.port, treqs, tmp)
            _, n_launch = gate_inprocess("tenancy", fleet)
            series = prom(router_metrics.render())
        finally:
            fleet.stop()
        by = {a: {c: [n for n, r in enumerate(res)
                      if treqs[n]["app"] == a and r[0] == c]
                  for c in (200, 429)} for a in keys}
        other = [r[0] for r in res if r[0] not in (200, 429)]
        if other or by["calm"][429] or not by["flood"][429] \
                or not by["flood"][200]:
            fail(f"tenancy: statuses {sorted({r[0] for r in res})}; "
                 f"{ {a: {c: len(v) for c, v in d.items()} for a, d in by.items()} }")
        if any(not res[n][1] or int(res[n][1]) < 1
               for n in by["flood"][429]):
            fail("tenancy: a 429 without Retry-After")
        ok = by["calm"][200] + by["flood"][200]
        match_tables("tenancy", [res[n][2] for n in ok],
                     [treqs[n]["i"] for n in ok], tables[:1])
        counted = {a: {"admitted": series.get(
            f'pio_tenant_admitted_total{{app="{a}"}}', 0.0),
            "shed": series.get(
                f'pio_shed_total{{surface="quota",app="{a}"}}', 0.0)}
            for a in keys}
        if counted != {a: {"admitted": float(len(by[a][200])),
                           "shed": float(len(by[a][429]))} for a in keys}:
            fail(f"tenancy: /metrics {counted}, clients saw "
                 f"{ {a: {c: len(v) for c, v in d.items()} for a, d in by.items()} }")
        launches += n_launch
        out["tenancy"] = {
            "replicas": 1, "start_s": start_s, "requests": len(res),
            "flood_rate": FLOOD_RATE,
            "status_counts": {a: {str(c): len(v) for c, v in d.items()}
                              for a, d in by.items()},
            "metrics_counts": counted, "launches": n_launch,
            "all": lat_summary(res, range(len(res))),
            "by_app": {a: lat_summary(res, by[a][200]) for a in keys},
            "wall_s": max(r[4] for r in res) - min(r[3] for r in res)}
        registry.close()
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


# phase 4h, elastic: `cli deploy --supervised 1 --autoscale on` under a
# `cli loadsim` flash crowd. The router, not a child, bounds the fleet:
# loadsim opens a connection per arrival, and from 8 loadsim processes
# the router neared one core at 300 req/s (client p99 5.3 s) while the
# child used 0.8. Beside other work one loadsim process fell behind a
# 400-req/s flash (client-bound, PERF.md); alone on the host it kept
# its schedule, and the router passed it on. So a flash never loads a
# child past its knee, and its member p99, the only up-signal the
# router's ring has here, moves little: 7.8-12.5 ms at 50 req/s and
# 16.3-23.6 in this flash on a quiet host, 15.0-24.2 at 50 beside three
# busy loops, and 9.6-10.0 in most ticks of this flash on another host.
# What separates is an idle child: with no queries it answers only the
# router's /ready probes and /metrics scrapes, whose p99 read 1.0-2.4
# ms (none took 10 ms in any calibration), while a flash's read at least
# 9.6. So the flash comes to an idle service (a launch), the threshold is
# the histogram's 5-ms bound between the two, and the phase runs last,
# on a host of its own. Its peak is 200 req/s: any query rate from 50 up
# reads at least 9.6 ms, and at 400 the router sits at its one core, so
# a slower host queues the flash past loadsim's 10-s timeout (88 of 793
# arrivals of one process beside three busy loops)
ELASTIC_BASE_RPS = 0.0
ELASTIC_PEAK_RPS = 200.0
ELASTIC_BEFORE_S, ELASTIC_RAMP_S = 20.0, 2.0
ELASTIC_HOLD_S, ELASTIC_AFTER_S = 45.0, 30.0
ELASTIC_MAX = 3
ELASTIC_TSDB_INTERVAL_S = 5.0       # the router's scrape and decision tick
ELASTIC_P99_MS = 5.0                # the breach threshold
# loadsim processes sharing each rate, each a Poisson process at its
# share with a seed of its own (their sum is one at the whole rate)
ELASTIC_LOADSIM_PROCS = int(os.environ.get("CHIP_SMOKE_ELASTIC_PROCS", "1"))
LOADSIM_TIMEOUT_S = 10.0            # LoadRunner's per-request timeout
LATE_S = 0.05                       # loadsim's own bound for a late send
ELASTIC_CHECKED = (WIRE_PLAIN // 4, WIRE_BANNED // 4, WIRE_BIN // 4)
ELASTIC_CAL_S = 30.0                # a calibration rate's steady phase
# the phase's own PIO_AUTOSCALE_* (the JAX names): the p99 threshold
# above; a breach held for three 5-s ticks; the cooldown above a child's
# join on the card (10.2-17.8 s from respawn to admitted in phase fleet
# (c); 9.97-22.25 s from decision to admitted here); six flips in the
# window let one flash go 1 -> 3 -> 1 with room for one more pair; idle
# below IDLE_QPS a survivor (below half the peak); the 5-minute SLO burn
# outlasts the phase, so it does not vote
ELASTIC_KNOBS = {
    "PIO_AUTOSCALE_P99_MS": repr(ELASTIC_P99_MS),
    "PIO_AUTOSCALE_BREACH_TICKS": "3",
    "PIO_AUTOSCALE_IDLE_TICKS": "4",
    "PIO_AUTOSCALE_IDLE_QPS": "100",
    "PIO_AUTOSCALE_COOLDOWN_S": "30",
    "PIO_AUTOSCALE_FLAP_WINDOW_S": "300",
    "PIO_AUTOSCALE_MAX_FLIPS": "6",
    "PIO_AUTOSCALE_BURN": "1e9",
}


def http_text(port: int, path: str) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return resp.read().decode()


def ring_points(port: int, series: str, since: float) -> dict:
    """A server's /tsdb.json points of the series starting `series`
    since unix second `since`: {key: [(unix second, value), ...]}."""
    doc = json.loads(http_text(port, f"/tsdb.json?series={series}"
                                     f"&since={since}"))
    return {k: [tuple(p) for p in s["points"]]
            for k, s in doc["series"].items()}


class ElasticWatch:
    """Reads the autoscaled router on threads of its own. Every 0.25 s:
    the target and decision counts of its /metrics, and at each decision
    the member p99 and qps points of the router's ring that drove it.
    Every 0.02 s: the members of its /status.json (when each child was
    first admitted, first retiring, gone from the table). Once a tick
    interval, each admitted grown child's GET / counts (`read_counts`):
    the last read is kept, the disagreeing ones counted (a read can
    fall inside a batch). A child's p99 counts every request it
    answers, so these reads come no oftener than the router's scrape,
    and none goes to `replica0`, whose idle ticks before the flash gate
    (a). From the moment a child turns `retiring` (out of rotation,
    drained, then stopped) its counts are read without pause until it
    stops answering: its last read is `final`."""

    def __init__(self, port: int, t0: float):
        self.port, self.t0 = port, t0
        self.t0_unix = time.time() - (time.perf_counter() - t0)
        self.decisions, self.admitted_at, self.retiring_at = [], {}, {}
        self.gone_at, self.ports = {}, {}
        self.last, self.final = {}, {}
        self.disagreed = {}
        self._read_at = {}
        self.peak = 0
        self.target = None
        self._seen = {"up": 0.0, "down": 0.0}
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._run, daemon=True,
                                          args=(f, dt))
                         for f, dt in ((self._read, 0.25),
                                       (self._members, 0.02))]
        for th in self._threads:
            th.start()

    def stop(self) -> None:
        self._stop.set()
        for th in self._threads:
            th.join(30)

    def _run(self, read, period: float) -> None:
        while not self._stop.wait(period):
            try:
                read()
            except (OSError, ValueError, KeyError):
                continue     # a router or child between states

    def _read(self) -> None:
        series = prom(http_text(self.port, "/metrics"))
        at = time.perf_counter() - self.t0
        self.target = series.get("pio_autoscale_children")
        self.peak = max(self.peak, int(self.target or 0))
        for d in ("up", "down"):
            got = series.get(
                f'pio_autoscale_decisions_total{{direction="{d}"}}', 0.0)
            while self._seen[d] < got:
                self._seen[d] += 1
                since = time.time() - 4 * ELASTIC_TSDB_INTERVAL_S
                ring = ring_points(self.port, "pio_fleet_member_", since)
                self.decisions.append({
                    "direction": d, "at_s": at,
                    "member_p99_ms": {k: [1e3 * v for _, v in pts]
                                      for k, pts in ring.items()
                                      if "p99" in k},
                    "member_qps": {k: [v for _, v in pts]
                                   for k, pts in ring.items()
                                   if "_qps" in k}})

    def _members(self) -> None:
        members = json.loads(http_text(self.port, "/status.json"))[
            "replicas"]
        at = time.perf_counter() - self.t0
        names = {m["name"] for m in members}
        for m in members:
            name = m["name"]
            if not name:
                continue
            if m["admitted"] and name not in self.admitted_at:
                self.admitted_at[name] = at
            self.ports[name] = m["port"]
            if m["state"] == "retiring" and name not in self.retiring_at:
                self.retiring_at[name] = at
                threading.Thread(target=self._final_reads, daemon=True,
                                 args=(name, m["port"])).start()
            if m["admitted"] and name != "replica0" and at - \
                    self._read_at.get(name, -1e9) >= ELASTIC_TSDB_INTERVAL_S:
                self._read_at[name] = at
                self._note(name, *read_counts(m["port"]))
        for name in self.admitted_at:
            if name not in names and name not in self.gone_at:
                self.gone_at[name] = at

    def _note(self, name: str, got: dict, ok: bool) -> None:
        self.last[name] = (got, ok)
        if not ok:
            self.disagreed[name] = self.disagreed.get(name, 0) + 1

    def _final_reads(self, name: str, port: int) -> None:
        end = time.monotonic() + 120
        while not self._stop.is_set() and time.monotonic() < end:
            try:
                self.final[name] = read_counts(port)
            except (OSError, ValueError, KeyError):
                return       # stopped answering: the last read stands
            time.sleep(0.002)


class Loadsim:
    """ELASTIC_LOADSIM_PROCS `cli loadsim` processes of one scenario."""

    def __init__(self, procs: list, name: str, duration_s: float):
        self.procs, self.name, self.duration_s = procs, name, duration_s

    def poll(self):
        """None while any process runs."""
        codes = [p.poll() for p in self.procs]
        return None if None in codes else codes


def elastic_loadsim(tmp: Path, cli, port: int, name: str,
                    phases: list) -> Loadsim:
    """`cli loadsim` of one app over phase 4's population (users u<n>,
    items i<n>, Zipf 1.1, loadsim's shape mix) against `port`, in
    ELASTIC_LOADSIM_PROCS processes each with its share of every rate and
    a seed of its own, started in the background; `elastic_loadsim_end`
    waits for them."""
    k = ELASTIC_LOADSIM_PROCS
    procs = []
    for j in range(k):
        share = [{**p, **{r: p[r] / k for r in ("rps", "peak_rps")
                          if r in p}} for p in phases]
        doc = {"name": name, "seed": 11 + j, "apps": [{
            "key": "ELASTIC", "name": "elastic", "n_users": N_USERS,
            "n_items": N_ITEMS, "zipf_s": 1.1, "phases": share}]}
        stem = tmp / f"{name}_{j}"
        Path(f"{stem}.json").write_text(json.dumps(doc))
        out = open(f"{stem}.out", "w+")
        proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli", "loadsim",
             "--", "--scenario", f"{stem}.json", "--port", str(port),
             "--samples", f"{stem}.samples.json"], cwd=tmp, env=cli.env,
            stdout=out, stderr=subprocess.STDOUT, text=True)
        proc.out, proc.samples = out, Path(f"{stem}.samples.json")
        _BACKGROUND.add(proc)
        procs.append(proc)
    return Loadsim(procs, name, sum(p["duration_s"] for p in phases))


def elastic_loadsim_end(load: Loadsim) -> dict:
    """Wait for an `elastic_loadsim`; (b): every process exits 0 and
    every arrival was answered 200. Returns the summed records, the
    merged timeline ([scheduled s, status, latency s, sent s] on each
    process's own clock) and each process's unix start."""
    recs, timeline, starts = {}, [], []
    prefix = f"loadsim_{load.name}_"
    for proc in load.procs:
        code = proc.wait(timeout=load.duration_s + 2 * LOADSIM_TIMEOUT_S
                         + 120)
        _BACKGROUND.discard(proc)
        proc.out.seek(0)
        text = proc.out.read()
        proc.out.close()
        if code != 0:
            fail(f"elastic (b): loadsim exited {code}: {text[-2000:]}")
        mine = {}
        for line in text.splitlines():
            if line.startswith("{"):
                rec = json.loads(line)
                mine[rec["metric"][len(prefix):]] = rec["value"]
        doc = json.loads(proc.samples.read_text())
        statuses = sorted({s for _, s, _, _ in doc["timeline"]})
        if statuses != [200] or len(doc["timeline"]) != mine.get("requests"):
            fail(f"elastic (b): loadsim statuses {statuses}, "
                 f"{len(doc['timeline'])} samples, records {mine}")
        for key in ("requests", "ok", "shed", "errors"):
            recs[key] = recs.get(key, 0) + mine[key]
        recs["late"] = recs.get("late", 0) + doc["late"]
        timeline += doc["timeline"]
        starts.append(doc["started"])
    return {"records": recs, "timeline": sorted(timeline),
            "starts": starts}


def loadsim_windows(timeline: list, bounds: dict) -> dict:
    """Per window [lo, hi) of the schedule: the arrivals scheduled in it
    and those sent in it, each as a count and a rate; the late ones
    (sent more than LATE_S behind); p50 and p99 ms from the send (what
    loadsim reports) and from the scheduled second (where the client
    fell behind, the truer one)."""
    out = {}
    for name, (lo, hi) in bounds.items():
        rows = [(dt, sent - t) for t, _, dt, sent in timeline
                if lo <= t < hi]
        sent = sum(1 for _, _, _, s in timeline if lo <= s < hi)
        span = hi - lo
        w = {"scheduled": len(rows), "scheduled_rps": len(rows) / span,
             "sent": sent, "sent_rps": sent / span,
             "late": sum(1 for _, lag in rows if lag > LATE_S)}
        if rows:
            send = np.sort([dt for dt, _ in rows])
            sched = np.sort([dt + lag for dt, lag in rows])
            at = (len(rows) // 2, int(0.99 * (len(rows) - 1)))
            w.update({"p50_ms": 1e3 * send[at[0]], "p99_ms": 1e3 * send[at[1]],
                      "from_schedule_p50_ms": 1e3 * sched[at[0]],
                      "from_schedule_p99_ms": 1e3 * sched[at[1]]})
        out[name] = w
    return out


def cpu_seconds(pid: int) -> float:
    """User plus system CPU seconds of process `pid` (/proc)."""
    fields = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def route_latency(port: int) -> dict:
    """A server's request histogram by route: {route: [requests, over
    10 ms, over 25 ms]}."""
    buckets = {}
    for key, v in prom(http_text(port, "/metrics")).items():
        if key.startswith("pio_http_request_duration_seconds_bucket{"):
            labels = dict(kv.split("=", 1)
                          for kv in key[key.index("{") + 1:-1].split(","))
            buckets.setdefault(labels["route"].strip('"'), {})[
                labels["le"].strip('"')] = v
    return {r: [b["+Inf"], b["+Inf"] - b["0.01"], b["+Inf"] - b["0.025"]]
            for r, b in buckets.items()}


def elastic_calibration(tmp: Path, cli, port: int, router_pid: int,
                        child: dict, rates: list) -> None:
    """With the autoscaler off: for each rate a steady loadsim of
    ELASTIC_CAL_S, then one line (phase `elastic_calibration_rate`): the
    child's member p99 and qps from the router's ring and its batch
    queue-delay p99 from its own over the last three quarters of the
    run, the client's schedule against what it sent, the child's
    requests by route over 10 and 25 ms, and the router's and the
    child's CPU seconds per second. CHIP_SMOKE_ELASTIC_BUSY=n runs n
    busy-loop processes beside it (a host's other work)."""
    busy = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(int(os.environ.get("CHIP_SMOKE_ELASTIC_BUSY",
                                              "0")))]
    _BACKGROUND.update(busy)
    pids = {"router": router_pid, "child": http_status(child["port"])["pid"]}
    for rate in rates:
        cpu0, routes0 = ({k: cpu_seconds(v) for k, v in pids.items()},
                         route_latency(child["port"]))
        t0 = time.perf_counter()
        load = elastic_loadsim(tmp, cli, port, f"cal_{int(rate)}", [
            {"kind": "steady", "duration_s": ELASTIC_CAL_S, "rps": rate}])
        res = elastic_loadsim_end(load)
        wall = time.perf_counter() - t0
        cpu1, routes1 = ({k: cpu_seconds(v) for k, v in pids.items()},
                         route_latency(child["port"]))
        since = time.time() - 0.75 * ELASTIC_CAL_S
        ring = ring_points(port, "pio_fleet_member_", since)
        delay = ring_points(child["port"], "pio_queue_delay_seconds", since)
        emit({
            "phase": "elastic_calibration_rate", "rate": rate,
            "loadsim_procs": ELASTIC_LOADSIM_PROCS, "busy_loops": len(busy),
            "loadsim": res["records"],
            "client": loadsim_windows(res["timeline"], {
                "all": (0.0, ELASTIC_CAL_S),
                "last_three_quarters": (0.25 * ELASTIC_CAL_S,
                                        ELASTIC_CAL_S)}),
            "member_p99_ms": [1e3 * v for k, pts in ring.items()
                              if "p99" in k for _, v in pts],
            "member_qps": [v for k, pts in ring.items() if "_qps" in k
                           for _, v in pts],
            "delay_p99_ms": [1e3 * v for k, pts in delay.items()
                             if k.endswith(":p99") for _, v in pts],
            "child_routes": {r: [n - routes0.get(r, [0, 0, 0])[i]
                                 for i, n in enumerate(v)]
                             for r, v in routes1.items()},
            "cpu_s_per_s": {k: (cpu1[k] - cpu0[k]) / wall for k in pids}})
    for proc in busy:
        proc.kill()
        proc.wait()
        _BACKGROUND.discard(proc)


def phase_elastic(torch, ft, dev, rng, model, card: str,
                  calibrate: Optional[list] = None) -> dict:
    """Phase 4's model recorded as a COMPLETED instance in a SQLITE store
    of its own, served by `cli deploy --supervised 1 --autoscale on
    --autoscale-min 1 --autoscale-max ELASTIC_MAX` (the phase's
    PIO_AUTOSCALE_* and PIO_TSDB_INTERVAL_S) under `cli loadsim`: base
    rate, a flash to ELASTIC_PEAK_RPS, base again. Gates: (a) the
    autoscaler grows during the flash and `scale1` is admitted and
    answers; (b) every loadsim arrival is answered 200; (c) a checked
    pass of phase wire's mix through the router after the grow, every
    answer bit-identical to the single-device K1 answer, and on each
    child K1 launches = plan calls = warmed buckets + drained chunks, no
    K2 launch; (d) after the load the target returns to 1, the retired
    children's processes are gone and none respawned, `retire`
    transitions rose, `eject` and the respawns did not; (e) /federate,
    the member gauges and /fleet.html cover every admitted member; (f)
    no child rebuilt the kernel library. `calibrate` (rates) runs the
    deploy with the autoscaler off and reports each rate's signals."""
    from predictionio_tpu_torch.data.storage import StorageRegistry
    t_phase = time.perf_counter()
    reqs = wire_requests(torch, ft, dev, rng, model, *ELASTIC_CHECKED)
    for n, r in enumerate(reqs):
        r["i"] = n
    queries = [r["query"] for r in reqs]
    table = k1_answers(torch, ft, dev, model, queries)
    out = {"phase": "elastic", "card": card, "users": N_USERS,
           "items": N_ITEMS, "rank": RANK, "k": K,
           "table_max_abs_err": check_answers(
               torch, ft, dev, model, queries,
               [[{"item": a, "score": b} for a, b in zip(*row)]
                for row in table]),
           "knobs": {**ELASTIC_KNOBS,
                     "PIO_TSDB_INTERVAL_S": ELASTIC_TSDB_INTERVAL_S},
           "rates": {"base": ELASTIC_BASE_RPS, "peak": ELASTIC_PEAK_RPS}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_elastic_") as tmp:
        tmp = Path(tmp)
        config = {"PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
                  "PIO_STORAGE_SOURCES_DB_PATH": str(tmp / "pio.db")}
        registry = StorageRegistry(config)
        t0 = time.perf_counter()
        iid = fleet_instance(registry, model)
        out["store_instance_s"] = time.perf_counter() - t0
        registry.close()
        lib = ft.build_library()
        lib_mtime = lib.stat().st_mtime_ns
        cli = cli_runner(tmp, {
            **config, **ELASTIC_KNOBS, "PIO_FLEET_HEARTBEAT_S": "0.5",
            "PIO_TSDB_INTERVAL_S": str(ELASTIC_TSDB_INTERVAL_S)})
        t0 = time.perf_counter()
        proc, line = start_server(
            tmp, cli, "deploy", "--supervised", "1", "--autoscale",
            "off" if calibrate else "on", "--autoscale-min", "1",
            "--autoscale-max", str(ELASTIC_MAX), "--engine-instance-id", iid,
            "--port", "0", "--batch-max", "64", "--server-key", FLEET_KEY)
        banner = ("(1 supervised replica processes" + (
            ")" if calibrate else f", autoscale [1, {ELASTIC_MAX}])"))
        if not (line.startswith("Fleet control plane started on ")
                and line.rstrip().endswith(banner)):
            proc.kill()
            fail(f"autoscaled deploy: {line!r} {stderr_tail(proc)}")
        port = int(line.split(" on ")[1].split()[0].rsplit(":", 1)[1])
        watch = None
        try:
            end = time.monotonic() + 300
            while True:
                members = json.loads(http_text(port, "/status.json"))[
                    "replicas"]
                if [m["name"] for m in members if m["admitted"]] == [
                        "replica0"]:
                    break
                if proc.poll() is not None or time.monotonic() > end:
                    fail(f"autoscaled deploy: replica0 not admitted "
                         f"{stderr_tail(proc)}")
                time.sleep(0.05)
            out["ready_s"] = time.perf_counter() - t0
            if calibrate:
                out["phase"] = "elastic_calibration"
                elastic_calibration(tmp, cli, port, proc.pid, members[0],
                                    calibrate)
            else:
                watch = ElasticWatch(port, t_phase)
                elastic_flash(out, tmp, cli, port, reqs, table, watch)
        finally:
            if watch is not None:
                watch.stop()
            stop_deploy(proc, "autoscaled deploy")
        if lib.stat().st_mtime_ns != lib_mtime:
            fail("elastic (f): a child rebuilt the kernel library")
    out["library_rebuilt_by_a_child"] = False
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


def elastic_flash(out: dict, tmp: Path, cli, port: int, reqs: list,
                  table: list, watch) -> None:
    """Phase elastic's flash, its checked pass and its gates (a)-(e)."""
    def router():
        return prom(http_text(port, "/metrics"))

    def table_members():
        return json.loads(http_text(port, "/status.json"))["replicas"]

    def respawns(series):
        return prom_sum(series, "pio_supervisor_respawns_total")

    before = router()
    flash_s = 2 * ELASTIC_RAMP_S + ELASTIC_HOLD_S
    load = elastic_loadsim(tmp, cli, port, "flash", [
        {"kind": "steady", "duration_s": ELASTIC_BEFORE_S,
         "rps": ELASTIC_BASE_RPS},
        {"kind": "flash", "duration_s": flash_s, "rps": ELASTIC_BASE_RPS,
         "peak_rps": ELASTIC_PEAK_RPS, "at_s": 0.0,
         "ramp_s": ELASTIC_RAMP_S, "hold_s": ELASTIC_HOLD_S},
        {"kind": "steady", "duration_s": ELASTIC_AFTER_S,
         "rps": ELASTIC_BASE_RPS}])
    t_load = time.perf_counter() - watch.t0
    # (a) a grow under the flash, scale1 admitted
    end = time.monotonic() + load.duration_s + 60
    while "scale1" not in watch.admitted_at:
        if load.poll() is not None or time.monotonic() > end:
            ring = {k: [(round(t - watch.t0_unix, 1), v) for t, v in pts]
                    for k, pts in ring_points(
                        port, "pio_fleet_member_", watch.t0_unix).items()
                    if "p99" in k or "_qps" in k}
            fail(f"elastic (a): no grown child admitted during the flash; "
                 f"decisions {watch.decisions}, target {watch.target}, "
                 f"member p99 s and qps by phase second {ring}")
        time.sleep(0.1)
    # (c) the checked pass through the router, then every child's counts
    members = [m for m in table_members() if m["admitted"]]
    res = wire_clients(port, reqs, tmp)
    codes = sorted({r[0] for r in res})
    if codes != [200]:
        fail(f"elastic (c): statuses {codes}")
    match_tables("elastic (c)", [r[2] for r in res], range(len(res)),
                 [table])
    checked = [child_counts(m, "after the checked pass", settle_s=10.0)
               for m in members]
    if not any(c["name"] == "scale1" and c["requests"] > 0
               for c in checked):
        fail(f"elastic (a): scale1 answered no request: {checked}")
    # (e) federation over every admitted member
    end = time.monotonic() + 6 * ELASTIC_TSDB_INTERVAL_S
    keys = [m["member"] for m in members]
    while True:
        fed, series = http_text(port, "/federate"), router()
        missing = [k for k in keys if f'member="{k}"' not in fed or not all(
            f'{g}{{member="{k}"}}' in series for g in (
                "pio_fleet_member_qps", "pio_fleet_member_p99_seconds"))]
        if not missing:
            break
        if time.monotonic() > end:
            fail(f"elastic (e): members {missing} missing from /federate "
                 "or the member gauges")
        time.sleep(0.2)
    page = http_text(port, "/fleet.html")
    if any(f"<td>{k}</td>" not in page for k in keys):
        fail("elastic (e): /fleet.html lacks a member row")
    # (b) every arrival answered
    sim = elastic_loadsim_end(load)
    # (a) the grow came from the flash: the breach streak behind the
    # first up (replica0's last BREACH_TICKS ticks before it) read over
    # the threshold on ticks inside the flash, the first up fell inside
    # the flash (or one tick after it, the tick that closed its last
    # breach), and most ticks of the base read below the threshold. A
    # lone base tick over it (one slow /ready or /metrics of the dozen
    # an idle tick counts) cannot grow the fleet: it is counted
    starts = sim["starts"]
    ups = [d for d in watch.decisions if d["direction"] == "up"]
    flash_unix = min(starts) + ELASTIC_BEFORE_S
    flash_at = (flash_unix - watch.t0_unix,
                max(starts) - watch.t0_unix + ELASTIC_BEFORE_S + flash_s
                + ELASTIC_TSDB_INTERVAL_S)
    first = next(m["member"] for m in members if m["name"] == "replica0")
    pts = ring_points(port, "pio_fleet_member_p99_seconds", min(starts)).get(
        f"pio_fleet_member_p99_seconds{{member={first}}}", [])
    base = [1e3 * v for ts, v in pts
            if max(starts) + ELASTIC_TSDB_INTERVAL_S <= ts <= flash_unix]
    breach_ticks = int(ELASTIC_KNOBS["PIO_AUTOSCALE_BREACH_TICKS"])
    streak = [] if not ups else [
        (ts - watch.t0_unix, 1e3 * v) for ts, v in pts
        if ts <= watch.t0_unix + ups[0]["at_s"]][-breach_ticks:]
    if len(base) < 2 or 2 * sum(b >= ELASTIC_P99_MS for b in base) >= len(
            base) or not (ups and flash_at[0] <= ups[0]["at_s"]
                          <= flash_at[1]) or len(streak) < breach_ticks \
            or not all(at > flash_at[0] and ms > ELASTIC_P99_MS
                       for at, ms in streak):
        fail(f"elastic (a): base ticks {base} ms against {ELASTIC_P99_MS}, "
             f"first up at {ups[0]['at_s'] if ups else None} s on the "
             f"streak (phase s, ms) {streak}, the flash {flash_at}")
    # (d) back to one child: the retired ones gone, none respawned
    end = time.monotonic() + 180
    while True:
        series = router()
        names = [m["name"] for m in table_members()]
        if (series.get("pio_autoscale_children") == 1.0
                and names == ["replica0"]
                and series.get('pio_supervisor_children{state="alive"}')
                == 1.0):
            break
        if time.monotonic() > end:
            fail(f"elastic (d): target {series.get('pio_autoscale_children')}"
                 f", members {names}, decisions {watch.decisions}")
        time.sleep(0.2)
    ups = [d for d in watch.decisions if d["direction"] == "up"]
    downs = [d for d in watch.decisions if d["direction"] == "down"]
    grown = [f"scale{k + 1}" for k in range(len(ups))]
    gone, retired = [], []
    for name in grown:
        # its reads from the moment it turned `retiring`, else its last
        # read of the watch; the last must agree (the sum below shows
        # that it came after the child's last answer)
        got = watch.final.get(name) or watch.last.get(name)
        if got is None:
            fail(f"elastic (d): {name} retired before a counts read (not "
                 f"admitted within the cooldown?): {watch.admitted_at}")
        counts, ok = got
        if not ok:
            fail(f"elastic (c): {name}'s last read before it left the "
                 f"rotation disagrees: {counts}")
        retired.append({"name": name, "read_while_retiring":
                        name in watch.final, **counts})
        try:
            os.kill(counts["pid"], 0)
        except ProcessLookupError:
            gone.append(name)
    delta = {ev: series.get(f'pio_fleet_transitions_total{{event="{ev}"}}',
                            0.0) - before.get(
        f'pio_fleet_transitions_total{{event="{ev}"}}', 0.0)
        for ev in ("retire", "eject")}
    if gone != grown or len(downs) != len(grown) \
            or delta != {"retire": float(len(grown)), "eject": 0.0} \
            or respawns(series) != respawns(before):
        fail(f"elastic (d): grown {grown}, gone {gone}, decisions "
             f"{len(ups)} up {len(downs)} down, transitions {delta}, "
             f"respawns {respawns(before)} -> {respawns(series)}")
    final = child_counts({"name": "replica0",
                          "port": watch.ports["replica0"]}, "after the load",
                         settle_s=10.0)
    children = [final] + retired
    # every answer the router counted was counted by a child at its last
    # read: no retired child answered after it
    routed = series.get('pio_fleet_routed_total{outcome="ok"}', 0.0)
    if sum(c["requests"] for c in children) != routed:
        fail(f"elastic (c): the children's last reads count "
             f"{sum(c['requests'] for c in children)} answers, the router "
             f"{routed}: {children}")
    out["launches"] = sum(c["launches"] for c in children)
    t0 = ELASTIC_BEFORE_S
    out.update({
        "load_started_at_s": t_load,
        "loadsim_started_at_s": [s - watch.t0_unix for s in starts],
        "flash_window_s": list(flash_at),
        "base_p99_ms": base,
        "base_ticks_over_threshold": sum(b >= ELASTIC_P99_MS for b in base),
        "first_up_streak": streak,
        "decisions": watch.decisions, "peak_children": watch.peak,
        "decision_to_admitted_s": {
            f"scale{k + 1}": watch.admitted_at[f"scale{k + 1}"] - d["at_s"]
            for k, d in enumerate(ups)},
        "retire_to_gone_s": {n: watch.gone_at[n] - watch.retiring_at[n]
                             for n in grown if n in watch.retiring_at
                             and n in watch.gone_at},
        "loadsim": {**sim["records"], **loadsim_windows(sim["timeline"], {
            "before": (0.0, t0), "during": (t0, t0 + flash_s),
            "after": (t0 + flash_s, load.duration_s)})},
        "checked": {"requests": len(res), "answers_bit_identical": len(res),
                    "all": lat_summary(res, range(len(res))),
                    "children": checked},
        "children": children, "routed_ok": routed,
        "disagreeing_reads": watch.disagreed,
        "transitions": delta})


CHAOS_CHECKED = 64         # (a): phase 4's queries held to the plain version
CHAOS_APP, CHAOS_KEY = "chaos", "CHAOSKEY"   # the drills' tenant key
CHAOS_EVENTS = 2_000       # the app's ratings: its refresher's watermark
# the drills whose topology serves in this process, run first; the other
# three route to stub child processes, whose cold starts wait on a host
# that the ML-1M chain loads, so they run last, beside the chain's tail
CHAOS_IN_PROCESS = ("handoff-budget", "hot-key", "lease-failover",
                    "mem-soft", "refresher-die", "refresher-stall")
CHAOS_CHILDREN = ("diurnal-1-N-1", "flash-crowd", "replica-kill")
SVC_USERS, SVC_ITEMS, SVC_RATINGS = 300, 200, 6_000   # (d)'s eval store
SVC_EVAL_MODULE = """
from predictionio_tpu_torch.core.evaluation import (EngineParamsGenerator,
                                                    Evaluation)
from predictionio_tpu_torch.core.params import EngineParams
from predictionio_tpu_torch.models import recommendation as rec

ChaosEvaluation = Evaluation(
    engine=rec.RecommendationEngine.apply(),
    metric=rec.PrecisionAtK(k=10, rating_threshold=4.0))
ChaosParams = EngineParamsGenerator([EngineParams(
    data_source_params=("", rec.DataSourceParams(
        app_name="svc", eval_params=rec.EvalParams(k_fold=2, query_num=10))),
    algorithm_params_list=(("als", rec.ALSAlgorithmParams(
        rank=8, num_iterations=4, seed=3)),))])
"""


def chaos_store(registry, model, rng) -> tuple:
    """The drills' store: app `chaos` with the key CHAOSKEY and
    CHAOS_EVENTS ratings of the model's users and items (its refresher's
    watermark), and phase 4's model as a COMPLETED instance whose data
    source names the app; returns (engine, instance)."""
    from predictionio_tpu_torch.core.workflow import resolve_engine
    from predictionio_tpu_torch.data.event import DataMap, Event
    from predictionio_tpu_torch.data.storage import AccessKey, App
    app_id = registry.get_meta_data_apps().insert(App(0, CHAOS_APP))
    registry.get_meta_data_access_keys().insert(
        AccessKey(CHAOS_KEY, app_id, ()))
    events = registry.get_events()
    events.init(app_id)
    users = rng.integers(0, N_USERS, CHAOS_EVENTS)
    items = rng.integers(0, N_ITEMS, CHAOS_EVENTS)
    for u, i in zip(users, items):
        events.insert(Event(
            event="rate", entity_type="user", entity_id=f"u{u}",
            target_entity_type="item", target_entity_id=f"i{i}",
            properties=DataMap({"rating": float(1 + (u + i) % 5)})), app_id)
    iid = fleet_instance(registry, model, app_name=CHAOS_APP)
    return (resolve_engine("recommendation"),
            registry.get_meta_data_engine_instances().get(iid))


def chaos_answers(torch, ft, dev, rng, model, tmp: Path, cli,
                  trained) -> dict:
    """(a) The instance deployed on the card (`deploy_instance`), 64 of
    phase 4's queries against the plain version, K1 launches = plan
    calls, one `cli top` view of it."""
    from predictionio_tpu_torch.cli.main import deploy_instance
    from predictionio_tpu_torch.core.runtime import RuntimeContext
    from predictionio_tpu_torch.ops import topk
    registry, engine, inst = trained
    n_items = model.item_factors.shape[0]
    queries = make_queries(torch, ft, dev, rng, model, CHAOS_CHECKED,
                           n_items)
    ft.LAUNCHES = 0
    topk.PLAN_CALLS = 0
    t0 = time.perf_counter()
    server = deploy_instance(engine, inst, RuntimeContext(
        registry=registry, device=dev), port=0, batch_max=64)
    out = {"deploy_s": time.perf_counter() - t0}
    try:
        answers = serve_http(server.port, queries, clients=16)
        launches, calls = ft.LAUNCHES, topk.PLAN_CALLS
        if not 0 < launches == calls:
            fail(f"chaos (a): K1 launches {launches}, plan calls {calls}")
        out["max_abs_err"] = check_answers(
            torch, ft, dev, model, queries,
            [body["itemScores"] for body, _ in answers], n_items)
        out["launches"] = launches
        top = subprocess.run(
            [sys.executable, "-m", "predictionio_tpu_torch.cli", "top",
             "--port", str(server.port)], cwd=tmp, env=cli.env,
            capture_output=True, text=True, timeout=120)
        lines = top.stdout.splitlines()
        if top.returncode != 0 or not lines or not lines[0].startswith(
                f"pio-tpu top — 127.0.0.1:{server.port}") or not any(
                "profiler:" in ln for ln in lines):
            fail(f"chaos (a): cli top exited {top.returncode}: "
                 f"{top.stdout[-2000:]} {top.stderr[-2000:]}")
        out["top"] = lines
    finally:
        server.stop()
    return out


def chaos_cli(tmp: Path, cli) -> dict:
    """(b) `cli chaos list` prints the nine drills with their
    descriptions; `cli chaos run refresher-die --json` (its tiny model
    trained on the card) exits 0 with an ok report."""
    from predictionio_tpu_torch.resilience import scenarios
    listed, _ = cli("chaos", "list")
    want = [{"name": n, "description": scenarios.get(n).description}
            for n in scenarios.names()]
    if listed != want or len(listed) != 9:
        fail(f"chaos (b): cli chaos list printed {listed}")
    reports, run_s = cli("chaos", "run", "refresher-die", "--json")
    if len(reports) != 1 or not reports[0]["ok"] \
            or reports[0]["failures"] or not reports[0]["requests"]:
        fail(f"chaos (b): cli chaos run refresher-die reported {reports}")
    return {"listed": len(listed), "refresher_die": reports[0],
            "run_s": run_s}


def chaos_drills(ft, dev, trained, names) -> dict:
    """(c) The drills `names` at full width, in this process: each
    report ok; in each in-process topology K1 launches rise and equal
    plan calls; no kernel build after the process's first; the
    refreshers' ticks read the app's watermark."""
    from predictionio_tpu_torch.obs import get_registry, kernelprobe
    from predictionio_tpu_torch.ops import topk
    from predictionio_tpu_torch.resilience import scenarios
    import logging
    # the fleet's member events (register, admit, retire, forget) on the
    # run's standard error: what a failed fleet drill is read from
    for name in ("fleet", "serving.autoscaler", "supervisor"):
        logging.getLogger(f"pio.torch.obs.{name}").setLevel(logging.INFO)
    builds = kernelprobe.build_count()
    reg = get_registry()
    outcomes = ("baseline", "noop", "no_app", "no_watermark", "failed")

    def ticks():
        return {o: reg.value("pio_streaming_refresh_total", outcome=o) or 0.0
                for o in outcomes}

    drills, launches = {}, 0
    for name in names:
        ft.LAUNCHES = 0
        topk.PLAN_CALLS = 0
        before = ticks()
        report = scenarios.run(name, trained=trained, device=dev)
        k1, calls = ft.LAUNCHES, topk.PLAN_CALLS
        after = ticks()
        row = {**report.to_json(), "k1_launches": k1, "plan_calls": calls,
               "refresh_ticks": {o: after[o] - before[o] for o in outcomes
                                 if after[o] > before[o]}}
        drills[name] = row
        emit({"phase": "chaos_drill", **row})
        if not report.ok:
            fail(f"chaos (c): {name} violated: {report.violations}")
        if name in CHAOS_IN_PROCESS and not 0 < k1 == calls:
            fail(f"chaos (c): {name}: K1 launches {k1}, plan calls {calls}")
        if name not in CHAOS_IN_PROCESS and k1:
            fail(f"chaos (c): {name} routes to stub children, yet K1 "
                 f"launched {k1} times in this process")
        if name.startswith("refresher-") and (
                not row["refresh_ticks"].get("baseline")
                or any(row["refresh_ticks"].get(o)
                       for o in ("no_app", "no_watermark"))):
            fail(f"chaos (c): {name}'s refresher ticked "
                 f"{row['refresh_ticks']}")
        launches += k1
    if kernelprobe.build_count() != builds:
        fail("chaos (c): a drill rebuilt the kernel library")
    return {"drills": drills, "launches": launches}


def free_ports(n: int) -> list:
    import socket
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def http_call(port: int, method: str, path: str, body=None):
    """(status, parsed JSON or text) of one request."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            raw = resp.read().decode()
            ct = resp.headers.get("Content-Type", "")
            return resp.status, json.loads(raw) if "json" in ct else raw
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def proc_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:
        return Path(f"/proc/{pid}/stat").read_text().split()[2] != "Z"
    except OSError:
        return True


def chaos_services(tmp: Path, rng) -> dict:
    """(d) A store of its own where `cli eval` of the recommendation
    template ran on the card (two folds over planted ratings); `cli
    start-all` on free ports with its own pid and log directories: the
    dashboard lists the evaluation, its JSON document equals the stored
    one, /metrics.html and /traces.html answer; the admin server lists,
    creates and deletes an app; the event server stores an event; `cli
    daemon` starts a fourth event server; `cli stop-all` stops all four,
    their processes gone and their pidfiles removed."""
    from predictionio_tpu_torch.data.event import DataMap, Event
    from predictionio_tpu_torch.data.storage import StorageRegistry
    t_part = time.perf_counter()
    svc = tmp / "svc"
    svc.mkdir()
    config = {"PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
              "PIO_STORAGE_SOURCES_DB_PATH": str(svc / "pio.db")}
    cli = cli_runner(svc, config)
    app, _ = cli("app", "new", "svc")
    registry = StorageRegistry(config)
    events = registry.get_events()
    u = rng.integers(0, SVC_USERS, SVC_RATINGS)
    i = rng.integers(0, SVC_ITEMS, SVC_RATINGS)
    for a, b in zip(u, i):
        events.insert(Event(
            event="rate", entity_type="user", entity_id=f"u{a}",
            target_entity_type="item", target_entity_id=f"i{b}",
            properties=DataMap({"rating": 5.0 if (a + b) % 3 == 0
                                else 2.0})), app["id"])
    (svc / "svc_eval.py").write_text(SVC_EVAL_MODULE)
    t0 = time.perf_counter()
    ev, _ = cli("eval", "svc_eval.ChaosEvaluation", "svc_eval.ChaosParams")
    out = {"eval_s": time.perf_counter() - t0}
    iid = ev["evaluationInstanceId"]
    stored = registry.get_meta_data_evaluation_instances().get(iid)
    registry.close()
    ports = free_ports(4)
    run, log = svc / "run", svc / "log"
    pids = {}
    try:
        t0 = time.perf_counter()
        started, _ = cli("start-all", "--ip", "127.0.0.1",
                         "--event-server-port", str(ports[0]),
                         "--dashboard-port", str(ports[1]),
                         "--admin-port", str(ports[2]),
                         "--pid-dir", str(run), "--log-dir", str(log))
        out["start_all_s"] = time.perf_counter() - t0
        pids = {d["name"]: d["pid"] for d in started}
        if sorted(pids) != ["adminserver", "dashboard", "eventserver"] or \
                any(d["status"] != "up" for d in started):
            fail(f"chaos (d): start-all started {started}")
        status, index = http_call(ports[1], "GET", "/")
        if status != 200 or iid not in index:
            fail(f"chaos (d): the dashboard's / ({status}) lists no "
                 f"evaluation {iid}")
        status, doc = http_call(ports[1], "GET",
                                f"/engine_instances/{iid}.json")
        if status != 200 or doc != json.loads(
                stored.evaluator_results_json):
            fail(f"chaos (d): /engine_instances/{iid}.json ({status}) is "
                 "not the stored results")
        for path in ("/metrics.html", "/traces.html",
                     f"/engine_instances/{iid}"):
            if http_call(ports[1], "GET", path)[0] != 200:
                fail(f"chaos (d): the dashboard's {path} did not answer 200")
        steps = [http_call(ports[2], "GET", "/cmd/app"),
                 http_call(ports[2], "POST", "/cmd/app", {"name": "svc2"}),
                 http_call(ports[2], "GET", "/cmd/app"),
                 http_call(ports[2], "DELETE", "/cmd/app/svc2"),
                 http_call(ports[2], "GET", "/cmd/app")]
        names = [sorted(a["name"] for a in body)
                 for status, body in steps[0::2]]
        if [s for s, _ in steps] != [200, 201, 200, 200, 200] or names != [
                ["svc"], ["svc", "svc2"], ["svc"]]:
            fail(f"chaos (d): the admin server answered {steps}")
        status, body = http_call(
            ports[0], "POST", f"/events.json?accessKey={app['accessKey']}",
            {"event": "rate", "entityType": "user", "entityId": "u1",
             "targetEntityType": "item", "targetEntityId": "i1",
             "properties": {"rating": 5}})
        if status != 201:
            fail(f"chaos (d): the event server answered {status} {body}")
        extra, _ = cli("daemon", "--name", "extra", "--pid-dir", str(run),
                       "--log-dir", str(log), "--", "eventserver", "--ip",
                       "127.0.0.1", "--port", str(ports[3]))
        pids["extra"] = extra["pid"]
        end = time.monotonic() + 60
        while True:
            try:
                if http_call(ports[3], "GET", "/")[0] == 200:
                    break
            except OSError:
                pass
            if time.monotonic() > end:
                fail("chaos (d): the daemon's event server never answered "
                     f"{(log / 'pio-extra.log').read_text()[-2000:]}")
            time.sleep(0.1)
    finally:
        stopped, _ = cli("stop-all", "--pid-dir", str(run))
    by_name = {d["name"]: d["status"] for d in stopped}
    alive = [n for n, pid in pids.items() if proc_alive(pid)]
    if by_name != {n: "stopped" for n in ("adminserver", "dashboard",
                                          "eventserver", "extra")} \
            or alive or list(run.glob("pio-*.pid")):
        fail(f"chaos (d): stop-all reported {stopped}; alive {alive}; "
             f"pidfiles {sorted(p.name for p in run.glob('pio-*.pid'))}")
    out.update({"evaluation": iid, "best_score": ev.get("bestScore"),
                "daemons_stopped": len(stopped),
                "seconds": time.perf_counter() - t_part})
    return out


def phase_chaos(torch, ft, dev, rng, model, card: str) -> dict:
    """Phase 4i: the chaos drills, `cli top` and the service commands
    over phase 4's model recorded in a SQLITE store of its own whose
    refresher ticks (app `chaos`): (a) its answers, (b) the CLI, (c) the
    nine drills, (d) the service commands."""
    from predictionio_tpu_torch.data.storage import StorageRegistry
    t_phase = time.perf_counter()
    out = {"phase": "chaos", "card": card, "users": N_USERS,
           "items": N_ITEMS, "rank": RANK}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_chaos_") as tmp:
        tmp = Path(tmp)
        config = {"PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
                  "PIO_STORAGE_SOURCES_DB_PATH": str(tmp / "pio.db")}
        registry = StorageRegistry(config)
        t0 = time.perf_counter()
        engine, inst = chaos_store(registry, model, rng)
        out["store_s"] = time.perf_counter() - t0
        trained = (registry, engine, inst)
        cli = cli_runner(tmp, config)
        t0 = time.perf_counter()
        out["a"] = chaos_answers(torch, ft, dev, rng, model, tmp, cli,
                                 trained)
        out["a"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["b"] = chaos_cli(tmp, cli)
        out["b"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["c"] = chaos_drills(ft, dev, trained,
                                CHAOS_IN_PROCESS + CHAOS_CHILDREN)
        out["c"]["seconds"] = time.perf_counter() - t0
        out["d"] = chaos_services(tmp, rng)
        registry.close()
    out["launches"] = out["a"]["launches"] + out["c"]["launches"]
    out["max_abs_err"] = out["a"]["max_abs_err"]
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


STORAGE_REQUESTS = 256        # (a), (b): phase wire's mix, a tenth of it
STORAGE_RATINGS = 25_000      # (c) planted ratings over ML-1M's shape
# (at 100,000 the phase took 63.5 s on an H100's host, past its 60-s
# budget, (c) 34.3 s of it; at 50,000 50.5 s, (c) 20.1 s, and the whole
# script 1,251.0 s against its 1,200-s limit)
STORAGE_CHANNEL_EVENTS = 1_000
STORAGE_PEVLOG_EVENTS = 4_000  # (d)
STORAGE_STALE_S = 60.0        # (b) doctor's --stale-after
STORAGE_BREAKER = {"BREAKER_THRESHOLD": "3", "BREAKER_RECOVERY_S": "2"}


def fake_pg(port: int = 0, db=None):
    """`tests/fakepg.py`'s loopback server (the repo's test double of the
    Postgres wire protocol, on an in-memory sqlite), bound to `port`
    (0 = any) and, given `db`, serving that database: a restart on the
    same port keeps the data, as a Postgres restart does. `crash()`
    closes the listener and every session."""
    import importlib.util
    import socket
    # by path: a `tests` package elsewhere on sys.path must not shadow it
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_fakepg", Path(__file__).resolve().parent / "tests"
        / "fakepg.py")
    fakepg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fakepg)
    FakePgServer = fakepg.FakePgServer

    class Pg(FakePgServer):
        def __init__(self):
            self.sessions = []
            super().__init__()
            if db is not None:
                self._db.close()
                self._db = db

        def server_bind(self):
            self.server_address = ("127.0.0.1", port)
            super().server_bind()

        def get_request(self):
            sock, addr = super().get_request()
            self.sessions.append(sock)
            return sock, addr

        def crash(self):
            self.shutdown()
            self.server_close()
            for sock in self.sessions:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    return Pg()


def cli_main(*args):
    """`predictionio_tpu_torch.cli` run in this process on the default
    registry: (its JSON output, exit code)."""
    import io
    import logging
    from predictionio_tpu_torch.cli.main import main as cli
    root = logging.getLogger()
    saved = (root.handlers[:], root.level)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli(list(args))
    finally:      # the CLI's logging.basicConfig leaves this process
        root.handlers, level = saved
        root.setLevel(level)
    text = out.getvalue().strip()
    try:
        return json.loads(text), rc
    except ValueError:
        fail(f"cli {' '.join(args)} printed {text[-2000:]!r} (exit {rc})")


def storage_serve(torch, ft, dev, registry, reqs, tmp: Path, what: str,
                  engine_json: Path, iid: Optional[str] = None,
                  sweep: bool = True) -> dict:
    """`cli deploy [--engine-instance-id iid]`'s two steps in this
    process (`ops.deploy_target`, then `cli.main.deploy_instance`, with
    the startup sweep unless `sweep` is False) over `registry`, `reqs`
    from the wire clients, GET /, stop. K1's count is set to 0 just
    before the deploy: launches = plan calls = warmed buckets + drained
    chunks."""
    from predictionio_tpu_torch.cli import ops as cli_ops
    from predictionio_tpu_torch.cli.main import deploy_instance
    from predictionio_tpu_torch.core.runtime import RuntimeContext
    from predictionio_tpu_torch.obs import MetricsRegistry
    ft.LAUNCHES = 0
    ft.SHARD_LAUNCHES = 0
    t0 = time.perf_counter()
    engine, inst = cli_ops.deploy_target(registry, engine_instance_id=iid,
                                         engine_json=str(engine_json))
    server = deploy_instance(engine, inst, RuntimeContext(
        registry=registry, device=dev), port=0, batch_max=64,
        metrics=MetricsRegistry(), startup_check=sweep)
    deploy_s = time.perf_counter() - t0
    try:
        plan = server.deployment.algos[0]._serve_plan
        res = wire_clients(server.port, reqs, tmp)
        launches, calls = ft.LAUNCHES, plan.calls
        sizes = server.batcher.batch_sizes()
        status = http_status(server.port)
    finally:
        server.stop()
    expected = len(plan.buckets) + sum(
        c * -(-n // plan.max_bucket) for n, c in sizes.items())
    if not launches == calls == expected or ft.SHARD_LAUNCHES:
        fail(f"storage {what}: K1 launches {launches}, plan calls {calls}, "
             f"expected {expected}, K2 {ft.SHARD_LAUNCHES}")
    bad = [r for r in res if r is None or r[0] != 200]
    if bad:
        fail(f"storage {what}: {len(bad)} requests not 200: {bad[0]}")
    return {"instance": status["engineInstanceId"], "res": res,
            "launches": launches, "deploy_s": deploy_s,
            "sweep_s": status["deploy_timings"].get("sweep_s"),
            **lat_summary(res, range(len(res)))}


def file_digest(path: Path) -> str:
    import hashlib
    return hashlib.sha256(path.read_bytes()).hexdigest()


def flip_byte(path: Path, at: int) -> None:
    with open(path, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0xFF]))


def storage_model_parts(torch, ft, dev, rng, model, config: dict,
                        tmp: Path) -> dict:
    """(a) and (b): phase 4's model as two COMPLETED instances, metadata
    on POSTGRES, blobs on REPLICATED over three LOCALFS directories
    (quorum 2; the third down while instance 2 is written), deployed,
    damaged, doctored and deployed again; every answer bit for bit one
    card's K1 answer."""
    from predictionio_tpu_torch.data.storage import (EngineInstance,
                                                     StorageRegistry,
                                                     set_default)
    from predictionio_tpu_torch.data.event import utcnow
    from predictionio_tpu_torch.resilience import faults
    from datetime import timedelta
    out: dict = {}
    reqs = wire_requests(torch, ft, dev, rng, model,
                         STORAGE_REQUESTS // 2, STORAGE_REQUESTS // 4,
                         STORAGE_REQUESTS // 4)
    queries = [r["query"] for r in reqs]
    table = k1_answers(torch, ft, dev, model, queries)
    out["table_max_abs_err"] = check_answers(
        torch, ft, dev, model, queries,
        [[{"item": a, "score": b} for a, b in zip(*row)] for row in table])
    engine_json = tmp / "engine.json"
    engine_json.write_text(json.dumps(
        {"id": "default", "engineFactory": "recommendation"}))
    registry = StorageRegistry(config)
    set_default(registry)
    t0 = time.perf_counter()
    iid1 = fleet_instance(registry, model)
    registry.get_model_data_models()._drain()   # all three copies written
    out["store_instance_s"] = time.perf_counter() - t0
    # instance 2 while FS3 is down: a quorum of two acknowledges it
    rule = faults().arm("storage.FS3.Models.insert", error=OSError)
    try:
        iid2 = fleet_instance(registry, model)
        registry.get_model_data_models()._drain()   # FS3's retries end
    finally:
        faults().clear()
    if rule.hits != 3:
        fail(f"storage (a): FS3's write was tried {rule.hits} times, not 3")
    blob = {t: tmp / t.lower() / f"pio_model_{iid2}" for t in
            ("FS1", "FS2", "FS3")}
    if not (blob["FS1"].exists() and blob["FS2"].exists()) \
            or blob["FS3"].exists():
        fail("storage (a): instance 2 is not on exactly FS1 and FS2")
    out["blob_bytes"] = blob["FS1"].stat().st_size
    launches = 0

    def served(what: str, want: str, **kw) -> dict:
        nonlocal launches
        run = storage_serve(torch, ft, dev, registry, reqs, tmp, what,
                            engine_json, **kw)
        if run["instance"] != want:
            fail(f"storage {what}: served {run['instance']}, not {want}")
        match_tables(f"storage {what}", [r[2] for r in run["res"]],
                     list(range(len(reqs))), [table])
        launches += run.pop("launches")
        run.pop("res")
        return run

    # (a) and (b1) in one deploy: FS1's copy of instance 2 has one byte
    # flipped, so the deploy's read repairs it from FS2's and serves
    flip_byte(blob["FS1"], blob["FS1"].stat().st_size // 2)
    out["a_deploy"] = served("(a)+(b1)", iid2)
    if file_digest(blob["FS1"]) != file_digest(blob["FS2"]):
        fail("storage (b1): read repair left FS1's copy unlike FS2's")
    # (b2) both copies corrupt, and a TRAINING row whose trainer died
    for t in ("FS1", "FS2"):
        flip_byte(blob[t], blob[t].stat().st_size - 7)
    beat = utcnow() - timedelta(seconds=2 * STORAGE_STALE_S)
    ghost = registry.get_meta_data_engine_instances().insert(EngineInstance(
        status="TRAINING", start_time=beat, heartbeat=beat,
        engine_id="default", engine_version="default",
        engine_variant="default", engine_factory="recommendation"))
    t0 = time.perf_counter()
    report, rc = cli_main("doctor", "--stale-after", str(STORAGE_STALE_S))
    out["doctor_s"] = time.perf_counter() - t0
    corrupt = sorted(f["target"] for f in report["fsck"]
                     if f["kind"] == "corrupt_blob"
                     and f"pio_model_{iid2}" in f["path"])
    stale = [f["id"] for f in report["janitor"]]
    if rc != 1 or corrupt != ["FS1", "FS2"] or stale != [ghost] \
            or report["unrepaired"] != 3:
        fail(f"storage (b2): doctor exit {rc}, report {report}")
    t0 = time.perf_counter()
    repaired, rc = cli_main("doctor", "--repair", "--stale-after",
                            str(STORAGE_STALE_S))
    out["doctor_repair_s"] = time.perf_counter() - t0
    acted = sorted(f["target"] for f in repaired["fsck"]
                   if f["action"].startswith("quarantined"))
    if rc != 0 or acted != ["FS1", "FS2"] or repaired["unrepaired"] \
            or [f["action"] for f in repaired["janitor"]] != [
                "marked FAILED"]:
        fail(f"storage (b2): doctor --repair exit {rc}, {repaired}")
    for t in ("FS1", "FS2"):
        q = tmp / t.lower() / ".quarantine" / f"pio_model_{iid2}"
        if not (q.exists() and q.with_name(q.name + ".reason").exists()):
            fail(f"storage (b2): {t}'s copy is not in quarantine")
    if registry.get_meta_data_engine_instances().get(ghost).status \
            != "FAILED":
        fail("storage (b3): the ghost TRAINING row is not FAILED")
    # deploy still resolves the newest COMPLETED instance, as the JAX
    # package does; its blob is gone from every replica, so the operator
    # deploys instance 1 by id (doctor --repair has just swept the store)
    from predictionio_tpu_torch.cli import ops as cli_ops
    from predictionio_tpu_torch.core.workflow import CoreWorkflow
    from predictionio_tpu_torch.core.runtime import RuntimeContext
    engine, inst = cli_ops.deploy_target(registry,
                                         engine_json=str(engine_json))
    try:
        CoreWorkflow.prepare_deploy(engine, inst, RuntimeContext(
            registry=registry, device=dev))
    except ValueError as e:
        out["b2_newest"] = {"instance": inst.id, "deploy": str(e)}
    else:
        fail("storage (b2): instance 2's deploy loaded a quarantined blob")
    if inst.id != iid2 or iid2 not in out["b2_newest"]["deploy"]:
        fail(f"storage (b2): deploy resolved {out['b2_newest']}")
    out["b2_deploy"] = served("(b2)", iid1, iid=iid1, sweep=False)
    out["doctor_findings"] = len(report["fsck"]) + len(report["janitor"])
    out["breakers"] = repaired["breakers"]
    out["launches"] = launches
    set_default(None)
    registry.close()
    return out


def storage_events_part(torch, ft, dev, rng, pg_config: dict, tmp: Path,
                        seed: int) -> dict:
    """(c): ratings imported into POSTGRES through the CLI, exported,
    imported into a SQLITE twin; both trained on the card; the stores'
    columns and the instances' answers equal; then the data commands."""
    from predictionio_tpu_torch.data import store as dstore
    from predictionio_tpu_torch.data.storage import (StorageRegistry,
                                                     set_default)
    u, i, r = planted(ML1M_USERS, ML1M_ITEMS, STORAGE_RATINGS, seed + 13)
    with open(tmp / "ratings.jsonl", "w") as f:
        for n, (a, b, c) in enumerate(zip(u.tolist(), i.tolist(),
                                          r.tolist())):
            f.write('{"event":"rate","entityType":"user","entityId":'
                    f'"u{a}","targetEntityType":"item","targetEntityId":'
                    f'"i{b}","properties":{{"rating":{c}}},"eventTime":'
                    f'{ML1M_BASE_MS + n}}}\n')
    (tmp / "ml1m.json").write_text(json.dumps({
        "id": "ml1m", "engineFactory": "recommendation",
        "datasource": {"params": {"app_name": "ml1m"}},
        "algorithms": [{"name": "als", "params": {
            "rank": TRAIN_RANK, "num_iterations": TRAIN_ITERS,
            "lambda_": TRAIN_REG, "seed": seed}}]}))
    twin_config = {"PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
                   "PIO_STORAGE_SOURCES_DB_PATH": str(tmp / "twin.db")}
    out: dict = {"ratings": STORAGE_RATINGS}
    regs = {"postgres": StorageRegistry(pg_config),
            "sqlite": StorageRegistry(twin_config)}
    instances, columns = {}, {}
    for name, reg in regs.items():
        set_default(reg)
        app, _ = cli_main("app", "new", "ml1m")
        src = tmp / ("ratings.jsonl" if name == "postgres"
                     else "export_postgres.jsonl")
        imp, _ = cli_main("import", "--appid", str(app["id"]),
                          "--input", str(src))
        exp, _ = cli_main("export", "--appid", str(app["id"]),
                          "--output", str(tmp / f"export_{name}.jsonl"))
        if not imp["imported"] == exp["exported"] == STORAGE_RATINGS:
            fail(f"storage (c) {name}: imported {imp}, exported {exp}")
        t0 = time.perf_counter()
        trained, _ = cli_main("train", "--engine-json",
                              str(tmp / "ml1m.json"), "--device", str(dev))
        if trained.get("status") != "COMPLETED":
            fail(f"storage (c) {name}: train {trained}")
        instances[name] = trained["engineInstanceId"]
        c = dstore.rating_columns(reg, "ml1m")
        columns[name] = c
        out[name] = {"app": app["id"],
                     "import_events_per_s": imp["imported"] / imp["seconds"],
                     "export_events_per_s": exp["exported"] / exp["seconds"],
                     "train_s": time.perf_counter() - t0,
                     "phase_timings": trained.get("phaseTimings", {})}
    a, b = columns["postgres"], columns["sqlite"]

    def rows(c):
        un = np.array(c.users.keys(), dtype=object)[c.user_ix]
        it = np.array(c.items.keys(), dtype=object)[c.item_ix]
        order = np.lexsort((it.astype(str), un.astype(str), c.t_millis))
        return (un[order], it[order], c.rating[order], c.t_millis[order])

    if a.n != STORAGE_RATINGS or any(
            not np.array_equal(x, y) for x, y in zip(rows(a), rows(b))):
        fail("storage (c): POSTGRES's and SQLITE's rating columns differ")
    jl = [(tmp / f"export_{n}.jsonl").read_text().splitlines()
          for n in regs]
    if sorted(jl[0]) != sorted(jl[1]):
        fail("storage (c): the two stores export different events")
    # both instances answer the same requests identically
    users = rng.integers(0, ML1M_USERS, STORAGE_REQUESTS)
    queries = [{"user": f"u{x}", "num": 10} for x in users.tolist()]
    answers = {}
    launches = 0
    from predictionio_tpu_torch.cli.main import deploy_instance
    from predictionio_tpu_torch.core.runtime import RuntimeContext
    from predictionio_tpu_torch.core.workflow import resolve_engine
    for name, reg in regs.items():
        ft.LAUNCHES = 0
        inst = reg.get_meta_data_engine_instances().get(instances[name])
        server = deploy_instance(resolve_engine("recommendation"), inst,
                                 RuntimeContext(registry=reg, device=dev),
                                 port=0, batch_max=64)
        try:
            plan = server.deployment.algos[0]._serve_plan
            answers[name] = [body for body, _ in
                             serve_http(server.port, queries, 16)]
            if ft.LAUNCHES != plan.calls:
                fail(f"storage (c) {name}: K1 launches {ft.LAUNCHES}, "
                     f"plan calls {plan.calls}")
            launches += ft.LAUNCHES
        finally:
            server.stop()
    if answers["postgres"] != answers["sqlite"]:
        diff = sum(x != y for x, y in zip(answers["postgres"],
                                          answers["sqlite"]))
        fail(f"storage (c): {diff} of {len(queries)} answers differ "
             "between the two stores' instances")
    out["launches"] = launches
    # the data commands on POSTGRES
    pg = regs["postgres"]
    set_default(pg)
    app_id = out["postgres"]["app"]
    events = pg.get_events()
    cli_main("app", "data-delete", "ml1m", "--force")
    if next(iter(events.find(app_id)), None) is not None:
        fail("storage (c): app data-delete left events")
    chan, _ = cli_main("app", "channel-new", "ml1m", "web")
    with open(tmp / "channel.jsonl", "w") as f:
        f.write("\n".join(jl[0][:STORAGE_CHANNEL_EVENTS]) + "\n")
    imp, _ = cli_main("import", "--appid", str(app_id), "--channel",
                      str(chan["id"]), "--input", str(tmp / "channel.jsonl"))
    got = sum(1 for _ in events.find(app_id, chan["id"]))
    if imp["imported"] != got or got != STORAGE_CHANNEL_EVENTS \
            or next(iter(events.find(app_id)), None) is not None:
        fail(f"storage (c): channel import {imp}, {got} found")
    cli_main("app", "channel-delete", "ml1m", "web", "--force")
    if pg.get_meta_data_channels().get_by_appid(app_id) or next(
            iter(events.find(app_id, chan["id"])), None) is not None:
        fail("storage (c): channel-delete left the channel or its events")
    keys = pg.get_meta_data_access_keys().get_by_appid(app_id)
    cli_main("accesskey", "delete", keys[0].key)
    if pg.get_meta_data_access_keys().get(keys[0].key) is not None:
        fail("storage (c): accesskey delete left the key")
    set_default(None)
    for reg in regs.values():
        reg.close()
    return out


def storage_pevlog_part(tmp: Path) -> dict:
    """(d): a torn frame appended to a PEVLOG segment; doctor reports it,
    --repair truncates it, a later append is found."""
    from predictionio_tpu_torch.data import store as dstore
    from predictionio_tpu_torch.data.event import DataMap, Event
    from predictionio_tpu_torch.data.storage import (App, StorageRegistry,
                                                     set_default)
    from predictionio_tpu_torch.native.eventlog import MAGIC
    import struct
    config = {"PIO_STORAGE_SOURCES_META_TYPE": "SQLITE",
              "PIO_STORAGE_SOURCES_META_PATH": str(tmp / "pev_meta.db"),
              "PIO_STORAGE_SOURCES_PEV_TYPE": "PEVLOG",
              "PIO_STORAGE_SOURCES_PEV_PATH": str(tmp / "pev"),
              "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "PEV"}
    registry = StorageRegistry(config)
    set_default(registry)
    app_id = registry.get_meta_data_apps().insert(App(0, "pev"))
    store = registry.get_events()
    t0 = ML1M_BASE_MS
    from predictionio_tpu_torch.data.event import from_millis

    def rate(n: int) -> Event:
        return Event("rate", "user", f"u{n % 97}", target_entity_type="item",
                     target_entity_id=f"i{n % 89}",
                     properties=DataMap({"rating": float(1 + n % 5)}),
                     event_time=from_millis(t0 + n))

    store.insert_batch([rate(n) for n in range(STORAGE_PEVLOG_EVENTS)],
                       app_id)
    store.close()
    seg = sorted((tmp / "pev" / f"app_{app_id}").glob("seg_*.log"))[-1]
    torn = struct.pack("<III", MAGIC, 200, 0) + b"x" * 40
    with open(seg, "ab") as f:
        f.write(torn)
    report, rc = cli_main("doctor")
    kinds = sorted(f["kind"] for f in report["fsck"])
    if rc != 1 or "torn_tail" not in kinds:
        fail(f"storage (d): doctor exit {rc}, {report['fsck']}")
    repaired, rc = cli_main("doctor", "--repair")
    tails = [f for f in repaired["fsck"] if f["kind"] == "torn_tail"]
    if rc != 0 or len(tails) != 1 or not tails[0]["action"].startswith(
            "truncated"):
        fail(f"storage (d): doctor --repair exit {rc}, {repaired['fsck']}")
    again, rc = cli_main("doctor")
    if rc != 0 or again["fsck"]:
        fail(f"storage (d): after the repair doctor finds {again['fsck']}")
    late = rate(STORAGE_PEVLOG_EVENTS).with_id()
    store.insert(late, app_id)
    found = [e.event_id for e in store.find(app_id)]
    cols = dstore.rating_columns(registry, "pev")
    if late.event_id not in found or len(found) != \
            STORAGE_PEVLOG_EVENTS + 1 or cols.n != STORAGE_PEVLOG_EVENTS + 1:
        fail(f"storage (d): the append after the repair is not read "
             f"({len(found)} found, {cols.n} columns)")
    set_default(None)
    registry.close()
    return {"events": STORAGE_PEVLOG_EVENTS, "torn_bytes": len(torn),
            "findings": kinds, "repair": tails[0]["action"]}


def storage_breaker_part(pg, pg_config: dict) -> tuple:
    """(e): an event server on POSTGRES (breaker threshold 3, recovery
    2 s); the server dies: after the threshold POSTs answer 503 with
    Retry-After and /ready is false, naming the source; restarted on the
    same port with its data, /ready comes back within the recovery time
    and a POST is stored. Returns (findings, the running server)."""
    from predictionio_tpu_torch.data.eventserver import (EventServer,
                                                         EventServerConfig)
    from predictionio_tpu_torch.data.storage import (AccessKey, App,
                                                     StorageRegistry)
    import urllib.error
    config = {**pg_config, **{f"PIO_STORAGE_SOURCES_PG_{k}": v
                              for k, v in STORAGE_BREAKER.items()}}
    registry = StorageRegistry(config)
    app_id = registry.get_meta_data_apps().insert(App(0, "breaker"))
    key = registry.get_meta_data_access_keys().insert(
        AccessKey("", app_id, ()))
    server = EventServer(EventServerConfig(ip="127.0.0.1", port=0),
                         registry)
    port = server.start()
    body = json.dumps({"event": "rate", "entityType": "user",
                       "entityId": "u1", "targetEntityType": "item",
                       "targetEntityId": "i1",
                       "properties": {"rating": 4}}).encode()

    def call(method: str, path: str, data=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.status, resp.headers, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, e.headers, json.loads(e.read())

    out: dict = {}
    try:
        if call("POST", f"/events.json?accessKey={key}", body)[0] != 201:
            fail("storage (e): a POST before the outage was not stored")
        db, pg_port = pg._db, pg.server_address[1]
        pg.crash()
        t0 = time.perf_counter()
        statuses = []
        while len(statuses) < 10:
            status, headers, _ = call("POST",
                                      f"/events.json?accessKey={key}", body)
            statuses.append(status)
            if status == 503:
                break
        out["statuses_until_503"] = statuses
        out["open_after_s"] = time.perf_counter() - t0
        threshold = int(STORAGE_BREAKER["BREAKER_THRESHOLD"])
        if statuses != [500] * threshold + [503] \
                or not headers.get("Retry-After"):
            fail(f"storage (e): statuses {statuses}, Retry-After "
                 f"{headers.get('Retry-After')}")
        ready = call("GET", "/ready")
        if ready[0] != 503 or ready[2].get("storageBreakers", {}).get(
                "PG") != "open":
            fail(f"storage (e): /ready during the outage {ready}")
        pg = fake_pg(pg_port, db)
        pg.__enter__()
        t1 = time.perf_counter()
        while call("GET", "/ready")[0] != 200:
            if time.perf_counter() - t1 > 10.0:
                fail("storage (e): /ready not back 10 s after the restart")
            time.sleep(0.05)
        out["ready_after_restart_s"] = time.perf_counter() - t1
        status, _, got = call("POST", f"/events.json?accessKey={key}", body)
        stored = registry.get_events().get(got.get("eventId", ""), app_id)
        if status != 201 or stored is None:
            fail(f"storage (e): after the restart POST {status} {got}")
        out["breakers"] = registry.breaker_states()
    finally:
        server.shutdown()
        registry.close()
    return out, pg


def phase_storage(torch, ft, dev, rng, model, card: str, seed: int) -> dict:
    """The storage drivers and their recovery, driven through the CLI and
    the servers, with `tests/fakepg.py` as the Postgres in this process:
    (a) phase 4's model from REPLICATED LOCALFS with metadata on
    POSTGRES; (b) damage, read repair, doctor, quarantine, the janitor;
    (c) events on POSTGRES against a SQLITE twin; (d) a torn PEVLOG
    tail; (e) the breaker. Parquet and OBJECTSTORE run where pyarrow and
    fsspec are installed, and the phase says so where they are not."""
    t_phase = time.perf_counter()
    out = {"phase": "storage", "card": card, "users": N_USERS,
           "items": N_ITEMS, "rank": RANK, "requests": STORAGE_REQUESTS}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_storage_") as tmp:
        tmp = Path(tmp)
        pg = fake_pg()
        url = pg.__enter__()
        try:
            pg_config = {"PIO_STORAGE_SOURCES_PG_TYPE": "POSTGRES",
                         "PIO_STORAGE_SOURCES_PG_URL": url}
            config = {**pg_config,
                      "PIO_STORAGE_SOURCES_REP_TYPE": "REPLICATED",
                      "PIO_STORAGE_SOURCES_REP_REPLICAS": "FS1,FS2,FS3",
                      "PIO_STORAGE_SOURCES_REP_QUORUM": "2",
                      "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "PG",
                      "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "PG",
                      "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "REP"}
            for t in ("FS1", "FS2", "FS3"):
                config[f"PIO_STORAGE_SOURCES_{t}_TYPE"] = "LOCALFS"
                config[f"PIO_STORAGE_SOURCES_{t}_PATH"] = str(
                    tmp / t.lower())
            t0 = time.perf_counter()
            out["model"] = storage_model_parts(torch, ft, dev, rng, model,
                                               config, tmp)
            out["model"]["seconds"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["events"] = storage_events_part(torch, ft, dev, rng,
                                                pg_config, tmp, seed)
            out["events"]["seconds"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["pevlog"] = storage_pevlog_part(tmp)
            out["pevlog"]["seconds"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["breaker"], pg = storage_breaker_part(pg, pg_config)
            out["breaker"]["seconds"] = time.perf_counter() - t0
            out["optional"] = storage_optional_parts(tmp)
        finally:
            pg.__exit__(None, None, None)
    out["launches"] = out["model"]["launches"] + out["events"]["launches"]
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


def storage_optional_parts(tmp: Path) -> dict:
    """Parquet export and import (pyarrow) and an OBJECTSTORE model
    store on fsspec's memory:// run where their package is installed;
    elsewhere the phase reports them as not run."""
    from predictionio_tpu_torch.data.event import DataMap, Event
    from predictionio_tpu_torch.data.storage import (Model,
                                                     StorageRegistry,
                                                     set_default)
    out: dict = {}
    try:
        import pyarrow  # noqa: F401
    except ImportError:
        out["parquet"] = "not run: pyarrow is not installed"
    else:
        reg = StorageRegistry({"PIO_STORAGE_SOURCES_M_TYPE": "MEM"})
        set_default(reg)
        events = [Event("rate", "user", f"u{n}", target_entity_type="item",
                        target_entity_id=f"i{n}",
                        properties=DataMap({"rating": 1.0 + n % 5})
                        ).with_id() for n in range(100)]
        reg.get_events().insert_batch(events, 1)
        cli_main("export", "--appid", "1", "--output",
                 str(tmp / "ev.parquet"), "--format", "parquet")
        cli_main("import", "--appid", "2", "--input",
                 str(tmp / "ev.parquet"), "--format", "parquet")
        back = {e.event_id: e.to_api_json() for e in
                reg.get_events().find(2)}
        if back != {e.event_id: e.to_api_json() for e in events}:
            fail("storage: the parquet round trip changed the events")
        out["parquet"] = "ok: 100 events exported and imported"
        set_default(None)
    try:
        import fsspec  # noqa: F401
    except ImportError:
        out["objectstore"] = "not run: fsspec is not installed"
    else:
        reg = StorageRegistry({
            "PIO_STORAGE_SOURCES_OS_TYPE": "OBJECTSTORE",
            "PIO_STORAGE_SOURCES_OS_URL": f"memory://chip-smoke-{os.getpid()}"})
        models = reg.get_model_data_models()
        models.insert(Model("m1", b"\x00\x01" * 1000))
        if models.get("m1").models != b"\x00\x01" * 1000 or models.fsck():
            fail("storage: the OBJECTSTORE round trip failed")
        out["objectstore"] = "ok: memory:// insert, get, fsck"
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


def profile_calls(torch, fn, iters: int, top: int = 12, warm: int = 3,
                  host_ops: bool = True) -> dict:
    """Device time per call by kernel name under `torch.profiler`, the
    device operations (kernels, copies, memsets) per call, and the
    device's busy share of the wall time (the profiler's own host
    cost inflates the wall time, so the share is a lower bound; less so
    without `host_ops`, the host operators' records). `warm` calls
    first, unprofiled."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * host_ops
                 + [ProfilerActivity.CUDA]) as prof:
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

    def start(*args):
        """The same command started in the background (its stderr to a
        file, so that nothing blocks on a full pipe); `finish` it."""
        err = open(tmp / f"cli_{args[0]}.err", "w+")
        proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli", *args],
            cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
        proc.started, proc.what, proc.err = (time.perf_counter(),
                                             " ".join(args), err)
        _BACKGROUND.add(proc)
        return proc

    def finish(proc):
        out, _ = proc.communicate(timeout=900)
        _BACKGROUND.discard(proc)
        proc.err.seek(0)
        err = proc.err.read()
        proc.err.close()
        if proc.returncode != 0:
            fail(f"cli {proc.what} exited {proc.returncode}: {err[-3000:]}")
        return json.loads(out), time.perf_counter() - proc.started

    cli.env, cli.start, cli.finish = env, start, finish
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
        # phase obs (d): the train under torch.profiler
        report, train_wall_s = cli("train", "--profile-dir",
                                   str(tmp / "train_profile"))
        if report["status"] != EngineInstanceStatus.COMPLETED:
            fail(f"the lifecycle instance is {report['status']}")
        obs_d = train_profile_gates(tmp / "train_profile", report)
        iid = report["engineInstanceId"]
        model, _ = read_model(config, iid, dev)
        heldout = heldout_rmse(model, u, i, r, test)
        if not heldout < 1.0:
            fail(f"lifecycle held-out RMSE {heldout} is not below 1.0")
        n_items = model.item_factors.shape[0]
        queries = make_queries(torch, ft, dev, rng, model, n_requests,
                               n_items)
        proc, port, deploy_wall_s = start_deploy(
            tmp, cli, iid, "--server-key", LIFECYCLE_KEY)
        try:
            t0 = time.perf_counter()
            answers = serve_http(port, queries)
            wall_s = time.perf_counter() - t0
            status = http_status(port)
            ops = lifecycle_operations(tmp, cli, config, proc, port, iid,
                                       n_requests, model.users.inverse,
                                       len(model.users))
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
                     "store_s": tm["store_s"],
                     "kernel_builds": report["kernelBuilds"]},
           "deploy": {"command_to_serving_s": deploy_wall_s,
                      **status["deploy_timings"]},
           "serve": {"requests": n_requests, "answers_checked": n_requests,
                     "max_abs_err": max_err, **gate,
                     "wall_s": wall_s, "qps": n_requests / wall_s,
                     "latency_ms": latency_ms(answers)},
           "operations": ops}
    emit(out)
    return {**out, "obs": obs_d}


def train_profile_gates(profile_dir: Path, report: dict) -> dict:
    """Phase obs (d): `cli train --profile-dir` wrote one Chrome trace
    that parses and holds CUDA kernel events, and the run built no
    kernel (`kernelBuilds` 0)."""
    t0 = time.perf_counter()
    files = sorted(profile_dir.glob("pio-train-*.pt.trace.json"))
    if len(files) != 1:
        fail(f"obs (d): --profile-dir wrote {[f.name for f in files]}")
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels or report["kernelBuilds"] != 0:
        fail(f"obs (d): {len(kernels)} CUDA kernel events of "
             f"{len(events)}, kernelBuilds {report['kernelBuilds']}")
    by_name = {}
    for e in kernels:
        name = e["name"][:80]
        by_name[name] = by_name.get(name, 0.0) + e.get("dur", 0.0)
    return {"trace_bytes": files[0].stat().st_size, "events": len(events),
            "kernel_events": len(kernels),
            "kernel_us": sum(by_name.values()),
            "top_kernels_us": dict(sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:5]),
            "kernel_builds": report["kernelBuilds"],
            "parse_s": time.perf_counter() - t0}


LIFECYCLE_KEY = "lifecycle-server-key"
# a client process that queries the deploy over 4 kept-alive
# connections until its stop file appears
QUERY_LOOP_CLIENT = r"""
import http.client, json, os, random, sys, threading, time
port, users_file, stop_file, out_file = (int(sys.argv[1]), sys.argv[2],
                                         sys.argv[3], sys.argv[4])
users = json.load(open(users_file))
codes, errors, lock = {}, [], threading.Lock()

def run(w):
    rnd = random.Random(w)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    while not os.path.exists(stop_file):
        body = json.dumps({"user": rnd.choice(users), "num": 10})
        try:
            conn.request("POST", "/queries.json", body,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = json.loads(resp.read())
            ok = resp.status == 200 and len(data["itemScores"]) == 10
            with lock:
                codes[resp.status] = codes.get(resp.status, 0) + 1
                if not ok:
                    errors.append([resp.status, data])
        except Exception as e:
            with lock:
                errors.append([-1, repr(e)])
            conn.close()
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=120)

threads = [threading.Thread(target=run, args=(w,)) for w in range(4)]
for t in threads:
    t.start()
print("started", flush=True)
for t in threads:
    t.join()
json.dump({"codes": codes, "errors": errors[:5],
           "n_errors": len(errors)}, open(out_file, "w"))
"""


def http_json(port: int, path: str, method: str = "GET",
              key: str = "") -> tuple:
    """(status, JSON body) of one request; the server key, if any, as
    the Basic username."""
    import base64
    import urllib.error
    headers = {}
    if key:
        headers["Authorization"] = "Basic " + base64.b64encode(
            f"{key}:".encode()).decode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method, headers=headers,
        data=b"" if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def lifecycle_operations(tmp: Path, cli, config: dict, proc, port: int,
                         iid: str, served_before: int, user_id,
                         n_users: int) -> dict:
    """What an operator runs against the deploy: `cli redeploy` (train,
    then POST /reload) while a client process keeps querying; a /reload
    onto a COMPLETED instance whose blob is gone (500, the old instance
    serves on); `cli undeploy` (the deploy process exits 0). Gates: no
    request fails, /status.json's instance flips, K1 launches = plan
    calls of both plans = two warmups + drained chunks (+ 1 for a batch
    straddling the publish)."""
    from predictionio_tpu_torch.data.event import utcnow
    from predictionio_tpu_torch.data.storage import StorageRegistry
    out = {}
    stop_file, res_file = tmp / "client.stop", tmp / "client.json"
    users_file = tmp / "client_users.json"
    users_file.write_text(json.dumps([user_id(u) for u in range(n_users)]))
    client = subprocess.Popen(
        [sys.executable, "-c", QUERY_LOOP_CLIENT, str(port),
         str(users_file), str(stop_file), str(res_file)],
        stdout=subprocess.PIPE, text=True)
    try:
        if client.stdout.readline().strip() != "started":
            fail("the lifecycle query client did not start")
        time.sleep(1.0)
        t0 = time.perf_counter()
        red = subprocess.run(
            [sys.executable, "-m", "predictionio_tpu_torch.cli", "redeploy",
             "--port", str(port), "--accesskey", LIFECYCLE_KEY], cwd=tmp,
            env=cli.env, capture_output=True, text=True, timeout=900)
        out["redeploy_s"] = time.perf_counter() - t0
        time.sleep(1.0)
    finally:
        stop_file.write_text("")
        client.wait(timeout=120)
    if red.returncode != 0 or not red.stdout.strip().endswith("Reloaded"):
        fail(f"cli redeploy exited {red.returncode}: {red.stdout[-500:]} "
             f"{red.stderr[-2000:]}")
    new_iid = json.loads(red.stdout[:red.stdout.rindex("}") + 1])[
        "engineInstanceId"]
    traffic = json.loads(res_file.read_text())
    if traffic["n_errors"] or list(traffic["codes"]) != ["200"]:
        fail(f"requests failed across the redeploy: {traffic}")
    code, st = http_json(port, "/status.json")
    if code != 200 or st["engineInstanceId"] != new_iid or new_iid == iid:
        fail(f"/status.json shows {st.get('engineInstanceId')} after the "
             f"redeploy to {new_iid} (was {iid})")
    queried = served_before + traffic["codes"]["200"]
    sizes = {int(k): v for k, v in st["batch_sizes"].items()}
    if sum(n * c for n, c in sizes.items()) != queried:
        fail(f"redeploy: batches {sizes} do not add up to {queried}")
    buckets, = st["plan_buckets"]
    expected = 2 * len(buckets) + sum(c * -(-n // max(buckets))
                                      for n, c in sizes.items())
    launches = st["kernel_launches"]["fused_topk"]
    if not (launches == st["process_plan_calls"]
            and expected <= launches <= expected + 1):
        fail(f"redeploy: K1 launches {launches}, plan calls of both plans "
             f"{st['process_plan_calls']}, expected {expected}")
    out.update(redeployed_to=new_iid, queries_during=traffic["codes"]["200"],
               launches=launches, plan_calls=st["process_plan_calls"],
               expected_calls=expected, instance_flipped=True)
    # a COMPLETED instance without its blob: the reload fails, rolls back
    reg = StorageRegistry(config)
    instances = reg.get_meta_data_engine_instances()
    ghost = instances.insert(instances.get(new_iid).with_(
        id="", start_time=utcnow()))
    reg.close()
    code, body = http_json(port, "/reload", "POST", LIFECYCLE_KEY)
    code_st, st = http_json(port, "/status.json")
    probe = http_post(port, {"user": user_id(0), "num": 10})[0]
    if code != 500 or st["engineInstanceId"] != new_iid or \
            len(probe["itemScores"]) != 10:
        fail(f"/reload onto blobless {ghost}: {code} {body}; serving "
             f"{st.get('engineInstanceId')}")
    out["rollback"] = {"status": code, "message": body.get("message"),
                       "serving": st["engineInstanceId"]}
    denied = http_json(port, "/stop", "POST")[0]
    t0 = time.perf_counter()
    und = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", "undeploy",
         "--port", str(port), "--accesskey", LIFECYCLE_KEY], cwd=tmp,
        env=cli.env, capture_output=True, text=True, timeout=120)
    try:
        code = proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        fail("the deploy process outlived `cli undeploy` by 30 s")
    if denied != 401 or und.returncode != 0 or code != 0:
        fail(f"undeploy: /stop without the key {denied}, cli undeploy "
             f"{und.returncode} {und.stdout!r}, deploy exit {code}")
    out["undeploy"] = {"stop_without_key": denied,
                       "exit_code": code,
                       "seconds_to_exit": time.perf_counter() - t0}
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


def pevlog_import(tmp: Path, seed: int, ingest=None) -> dict:
    """The lifecycle's generator and held-out split over SQLITE metadata
    and PEVLOG events in `tmp`, through the command line: `app new`,
    then `import`, `build` and `train` (the scan on 4 spawned workers)
    one after another on a background thread (phase lifecycle runs beside
    them), then `ingest(started, train)` (phase ingest's scans and
    train, `ingest_scan_train`), while the store is still as the train
    read it; `pevlog_project` waits for them."""
    from predictionio_tpu_torch.native.eventlog import EventLog

    u, i, r = planted(ML1M_USERS, ML1M_ITEMS, ML1M_N, seed + 5)
    test = np.random.default_rng(seed + 6).random(ML1M_N) < HELD_OUT
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
    started = {"tmp": tmp, "config": config, "cli": cli, "app": app,
               "u": u, "i": i, "r": r, "test": test, "seed": seed,
               "write_s": write_s, "uses_native": uses_native}

    def commands():
        imported = cli("import", "--appid", str(app["id"]), "--input",
                       "events.jsonl")
        cli("build")
        trained = cli("train")
        return imported, trained, (ingest(started, trained)
                                   if ingest is not None else None)

    pool = ThreadPoolExecutor(1, thread_name_prefix="pevlog-project")
    started["commands"] = pool.submit(commands)
    pool.shutdown(wait=False)
    return started


def pevlog_project(started: dict, dev) -> dict:
    """`pevlog_import`'s commands waited for. Gates: every event
    imported, the instance COMPLETED, held-out RMSE below 1.0. Returns
    what phases streaming and quickstart share: the store's config, the
    `cli` runner, the app, the instance and its model read back on
    `dev`."""
    from predictionio_tpu_torch.data.storage import EngineInstanceStatus
    cli, config, app = started["cli"], started["config"], started["app"]
    u, i, r, test = (started[k] for k in ("u", "i", "r", "test"))
    n_train = int((~test).sum())
    (imported, import_wall_s), (report, train_wall_s), ingest = \
        started["commands"].result()
    if imported["imported"] != n_train:
        fail(f"imported {imported['imported']} of {n_train} events")
    if report["status"] != EngineInstanceStatus.COMPLETED:
        fail(f"the PEVLOG instance is {report['status']}")
    iid = report["engineInstanceId"]
    model, row = read_model(config, iid, dev)
    heldout = heldout_rmse(model, u, i, r, test)
    if not heldout < 1.0:
        fail(f"PEVLOG held-out RMSE {heldout} is not below 1.0")
    return {"tmp": started["tmp"], "config": config, "cli": cli,
            "app": app, "app_id": app["id"], "iid": iid, "model": model,
            "row": row, "report": report, "n_train": n_train,
            "u": u, "i": i, "r": r, "test": test,
            "heldout": heldout, "uses_native": started["uses_native"],
            "write_s": started["write_s"], "seed": started["seed"],
            "imported": imported, "import_wall_s": import_wall_s,
            "train_wall_s": train_wall_s, "ingest": ingest}


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
QUALITY_CONVERSIONS = 32      # phase quality (d): predictions converted
QUALITY_ATTRIBUTION_S = 600.0  # the quickstart deploy's --attribution-s
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


def quality_conversions(events, app_id: int, rest, port: int,
                        proc) -> dict:
    """Phase quality (d), on phase quickstart's `deploy --feedback`
    instance: a `conversion` event (entity type `pio_pr`, so that the
    refresher folds nothing) for each of the QUALITY_CONVERSIONS newest
    `predict` events, carrying its `prId`, posted through the event
    server's batch route. Gates: each stored; the deploy's
    `/quality.json` joiner view for app ml1m reaches that many joins
    with a reward rate above 0 and no join outside the window; its
    per-app count equals the requests the deploy answered."""
    t_part = time.perf_counter()
    predicts = sorted(events.find(app_id, event_names=["predict"]),
                      key=lambda e: e.event_time)[-QUALITY_CONVERSIONS:]
    conv = [{"event": "conversion", "entityType": "pio_pr",
             "entityId": e.entity_id, "properties": {"prId": e.entity_id}}
            for e in predicts]
    code, reply = rest("POST", "/batch/events.json", conv)
    if code != 200 or [r["status"] for r in reply] != [201] * len(conv):
        fail(f"quality (d): the conversions' batch answered {code} {reply}")
    t_post = time.perf_counter()
    end = t_post + 60
    while True:
        if proc.poll() is not None:
            fail(f"quality (d): the deploy exited {proc.returncode}")
        q = quality_json(port)
        joined = ((q.get("joiner") or {}).get("apps") or {}).get("ml1m", {})
        if joined.get("joined_total", 0) >= len(conv) or \
                time.perf_counter() > end:
            break
        time.sleep(0.1)
    st = http_status(port)
    q = quality_json(port)
    served = q["apps"].get("", {}).get("n")
    joined = q["joiner"]["apps"].get("ml1m", {})
    if joined.get("joined_total") != len(conv) or not joined.get(
            "reward_rate", 0) > 0 or served != st["requests"]:
        fail(f"quality (d): joiner {q.get('joiner')}, quality count "
             f"{served} for {st['requests']} requests")
    return {"conversions": len(conv), "joined": joined["joined_total"],
            "unjoined": joined["unjoined_total"],
            "reward_rate": joined["reward_rate"],
            "pending": q["joiner"]["pending"],
            "attribution_s": q["joiner"]["attribution_s"],
            "joined_after_s": time.perf_counter() - t_post,
            "served_counted": served,
            "seconds": time.perf_counter() - t_part}


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
            "127.0.0.1", "--event-server-port", str(es_port),
            "--attribution-s", str(QUALITY_ATTRIBUTION_S))
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
        with urllib.request.urlopen(f"http://127.0.0.1:{es_port}/metrics",
                                    timeout=60) as resp:
            es_series = prom(resp.read().decode())
        es_wire = prom_sum(es_series, "pio_wire_requests_total{")
        es_ingested = {k.split('"')[1]: v for k, v in es_series.items()
                       if k.startswith("pio_events_ingested_total{")}
        if not es_wire or es_ingested.get("batch", 0) < INGEST_EVENTS:
            fail(f"the event server's /metrics: wire requests {es_wire}, "
                 f"ingested {es_ingested}")

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

        # phase quality (d): conversions of the latest predictions, joined
        # back to them by the deploy's feedback joiner
        quality_d = quality_conversions(events, app_id, rest, port,
                                        dep_proc)

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

    # 6. (started here) pio batchpredict through K1, beside the eval
    bp_queries = []
    for ux in range(len(model.users)):
        q = {"user": model.users.inverse(ux), "num": K}
        if ux % 2:
            q["blackList"] = [model.items.inverse(int(x)) for x in rng.choice(
                n_items, int(rng.integers(1, WIDTH + 1)), replace=False)]
        bp_queries.append(q)
    lines = [json.dumps(q) for q in bp_queries]
    (tmp / "bp_in.jsonl").write_text("\n".join(lines) + "\n")
    bp_proc = cli.start("batchpredict", "--input", "bp_in.jsonl",
                        "--output", "bp_out.jsonl")

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

    # 6. pio batchpredict through K1 (its process started before the eval)
    bp, bp_wall_s = cli.finish(bp_proc)
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
                      "wire": "selector",
                      "wire_requests": es_wire,
                      "metrics_events_ingested": es_ingested,
                      "threaded_wire_events_per_s":
                          THREADED_REST_EVENTS_PER_S,
                      "pevlog_import_events_per_s": import_events_per_s,
                      "pevlog_insert_ms_alone": pevlog_insert_ms(tmp),
                      "drip_ms_per_event": 1e3 * post_s / len(drip),
                      "stored": stored, "stats_counted": counted,
                      "refresher_caught_up_after_s": caught_up_s,
                      "ticks": ticks2,
                      "last_ticks": st2["refresh"]["last_ticks"],
                      "queries": load.summary()},
           "quality_d": quality_d,
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


# -- phase 14b: the remote ingest service -------------------------------------

INGEST_REQUESTS = 256        # (c): requests before the drip and after it
INGEST_VARIANT = "ml1m-ingest"   # (b)'s engine.json id: the project's own
# deploys keep resolving the project's instance
INGEST_PROBE = """
import hashlib, json

from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.data.storage import storage
from predictionio_tpu_torch.obs import get_registry


def digest(pc):
    h = hashlib.sha256()
    for a in (pc.left_ix, pc.right_ix, pc.weight):
        h.update(a.tobytes())
    h.update(json.dumps([pc.left.keys(), pc.right.keys()]).encode())
    return {"n": int(pc.n), "sha256": h.hexdigest()}


def pairs():
    out = digest(store.pair_columns(storage(), "ml1m", event_names=["rate"]))
    reg = get_registry()
    for outcome in ("ok", "fallback"):
        out[outcome] = reg.value("pio_ingest_remote_scans_total",
                                 outcome=outcome) or 0.0
    return out
"""


@contextlib.contextmanager
def env_set(**kv):
    """These environment variables set for the `with` block, restored
    after it."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def start_ingestd(tmp: Path, cli):
    """`cli ingestd --workers 4` over the project's store, in its own
    process group (its spawned scan workers die with it); returns (the
    process, its port)."""
    log = tmp / f"ingestd_{time.monotonic_ns()}.stderr"
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli", "ingestd",
             "--ip", "127.0.0.1", "--port", "0", "--workers", "4"],
            cwd=tmp, env=cli.env, stdout=subprocess.PIPE, stderr=err,
            text=True, start_new_session=True)
    proc.stderr_log, proc.group = log, True
    _BACKGROUND.add(proc)
    line = proc.stdout.readline()
    if not line.startswith("Ingest service started on 127.0.0.1:"):
        fail(f"ingestd did not come up: {line!r} {stderr_tail(proc)}")
    return proc, int(line.rsplit(":", 1)[1])


def http_metrics(port: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=60) as resp:
        return prom(resp.read().decode())


def process_tree(pid: int) -> set:
    """`pid` and its descendants, from /proc."""
    out, todo = set(), [pid]
    while todo:
        p = todo.pop()
        out.add(p)
        for task in Path(f"/proc/{p}/task").glob("*"):
            try:
                todo += [int(c) for c in
                         (task / "children").read_text().split()]
            except OSError:
                pass
    return out


def nvidia_fds(pids) -> int:
    """Open file descriptors of `pids` on the card's device files (a CUDA
    context opens them)."""
    n = 0
    for p in pids:
        for fd in Path(f"/proc/{p}/fd").glob("*"):
            with contextlib.suppress(OSError):
                n += os.readlink(fd).startswith("/dev/nvidia")
    return n


def off_card(proc, what: str) -> dict:
    """Fail if `proc` or a process it started holds a CUDA context: a pid
    in `nvidia-smi --query-compute-apps`, or an open /dev/nvidia* file.
    This process, which holds one, is the control: its device files are
    counted, and whether nvidia-smi lists it."""
    pids = {int(x) for x in subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.split()}
    tree = process_tree(proc.pid)
    on, fds = pids & tree, nvidia_fds(tree)
    if on or fds:
        fail(f"{what}: ingestd's processes {sorted(tree)} are on the card "
             f"(compute pids {sorted(on)}, {fds} device files open)")
    return {"compute_pids": sorted(pids), "ingestd_pids": len(tree),
            "smi_lists_this_process": os.getpid() in pids,
            "this_process_device_files": nvidia_fds([os.getpid()])}


def same_ratings(a, b) -> bool:
    return all(getattr(a, k).dtype == getattr(b, k).dtype
               and np.array_equal(getattr(a, k), getattr(b, k))
               for k in ("user_ix", "item_ix", "rating", "t_millis")) and \
        a.users.keys() == b.users.keys() and a.items.keys() == b.items.keys()


def factor_gap(torch, a, b) -> float:
    """Largest |difference| of two ALS models' factors; inf when their
    id tables differ."""
    if a.users.keys() != b.users.keys() or a.items.keys() != b.items.keys():
        return float("inf")
    return max(float((a.user_factors - b.user_factors).abs().max()),
               float((a.item_factors - b.item_factors).abs().max()))


def ingest_scan_train(torch, dev, started: dict, trained) -> dict:
    """Phase ingest's first half, on the PEVLOG project's thread right
    after its `cli train` (beside phase lifecycle in the whole run),
    while the store is as that train read it: `cli ingestd --workers 4`
    over the project's store; (a) the recommendation template's
    `rating_columns` through the service with the prepared cache off,
    from two consumers started together, each bit-identical to the
    local scan (the four columns and both tables), the service's
    /metrics counting one underlying scan and one coalesced
    subscription; (b) `cli train` through the service (an engine.json
    of variant INGEST_VARIANT, the same params): COMPLETED, held-out
    RMSE below 1.0, factors bit-identical to the project's locally
    scanned instance (where they are not, a second local train shows
    whether two local trains are, and the tolerance is twice their
    difference). ingestd never appears among the card's compute
    processes. Returns the state `ingest_serve_fold` goes on from."""
    from predictionio_tpu_torch.data import store as pstore
    from predictionio_tpu_torch.data.storage import (EngineInstanceStatus,
                                                     StorageRegistry)
    from predictionio_tpu_torch.models.recommendation import (
        DataSourceParams)

    t_phase = time.perf_counter()
    tmp, config, cli = started["tmp"], started["config"], started["cli"]
    app_id = started["app"]["id"]
    report0, train_wall0 = trained
    t = time.perf_counter()
    proc, port = start_ingestd(tmp, cli)
    service = f"127.0.0.1:{port}"
    parts = {"ingestd_start_s": time.perf_counter() - t}
    registry = StorageRegistry(config)
    events = registry.get_events()
    wm = events.ingest_watermark(app_id)

    # (a) two consumers against the local scan
    t_a = time.perf_counter()
    kw = dict(event_names=["rate", "buy"],
              value_spec={"rate": ("prop", "rating"), "buy": float(
                  DataSourceParams(app_name="ml1m").buy_rating)},
              dedup_last_wins=True)

    def timed_read():
        t0 = time.perf_counter()
        rc = pstore.rating_columns(registry, "ml1m", **kw)
        return rc, time.perf_counter() - t0

    with env_set(PIO_INGEST_CACHE="off", PIO_INGEST_WORKERS="4"):
        local, local_s = timed_read()
        m0 = http_metrics(port)
        with env_set(PIO_INGEST_SERVICE=service), \
                ThreadPoolExecutor(2) as pool:
            remote = [f.result() for f in [pool.submit(timed_read)
                                           for _ in range(2)]]
    m1 = http_metrics(port)
    for n, (rc, _) in enumerate(remote):
        if not same_ratings(rc, local):
            fail(f"ingest (a): consumer {n}'s remote rating columns differ "
                 "from the local scan")
    ok_key = 'pio_ingest_service_scans_total{outcome="ok"}'
    co_key = "pio_ingest_service_coalesced_total"
    scans = m1.get(ok_key, 0.0) - m0.get(ok_key, 0.0)
    coalesced = m1.get(co_key, 0.0) - m0.get(co_key, 0.0)
    if (scans, coalesced) != (1.0, 1.0):
        fail(f"ingest (a): two consumers made {scans} scans and "
             f"{coalesced} coalesced subscriptions (want 1 and 1)")
    blocks = m1.get("pio_ingest_service_blocks_total", 0.0)
    block_bytes = m1.get("pio_ingest_service_block_bytes_total", 0.0)
    card_a = off_card(proc, "ingest (a)")
    parts["a_s"] = time.perf_counter() - t_a
    a = {"rows": int(local.n), "users": len(local.users),
         "items": len(local.items), "local_s": local_s,
         "remote_s": [s for _, s in remote], "scans": scans,
         "coalesced": coalesced, "blocks": blocks,
         "block_bytes": block_bytes, "off_card": card_a}

    # (b) cli train through the service
    t_b = time.perf_counter()
    variant = json.loads((tmp / "engine.json").read_text())
    variant["id"] = INGEST_VARIANT
    (tmp / "engine_ingest.json").write_text(json.dumps(variant))
    cli_r = cli_runner(tmp, config, PIO_INGEST_WORKERS="4",
                       PIO_INGEST_SERVICE=service, PIO_INGEST_CACHE="off")
    report, train_wall_s = cli_r("train", "--engine-json",
                                 "engine_ingest.json")
    m2 = http_metrics(port)
    if events.ingest_watermark(app_id) != wm:
        fail("ingest (b): the store's watermark moved during the train")
    if report["status"] != EngineInstanceStatus.COMPLETED:
        fail(f"ingest (b): the instance is {report['status']}")
    iid = report["engineInstanceId"]
    model, row = read_model(config, iid, dev)
    local_model, _ = read_model(config, report0["engineInstanceId"], dev)
    heldout = heldout_rmse(model, *(started[k] for k in ("u", "i", "r",
                                                         "test")))
    if not heldout < 1.0:
        fail(f"ingest (b): held-out RMSE {heldout} is not below 1.0")
    served = m2.get(co_key, 0.0) + m2.get(ok_key, 0.0) - \
        m1.get(co_key, 0.0) - m1.get(ok_key, 0.0)
    if served != 1.0 or m2.get("pio_ingest_service_blocks_total",
                               0.0) <= blocks:
        fail(f"ingest (b): the train's read took {served} subscriptions "
             "of the service")
    gap = factor_gap(torch, model, local_model)
    twin = None
    if gap != 0.0:
        # is a local train on the card bit-reproducible at all?
        variant["id"] = INGEST_VARIANT + "-local"
        (tmp / "engine_local.json").write_text(json.dumps(variant))
        rep2, _ = cli_runner(tmp, config, PIO_INGEST_WORKERS="4",
                             PIO_INGEST_CACHE="off")(
            "train", "--engine-json", "engine_local.json")
        model2, _ = read_model(config, rep2["engineInstanceId"], dev)
        local_gap = factor_gap(torch, model2, local_model)
        twin = {"local_trains_gap": local_gap, "tolerance": 2 * local_gap}
        if local_gap == 0.0 or not gap <= 2 * local_gap:
            fail(f"ingest (b): factors {gap} from the local instance's, "
                 f"two local trains {local_gap} apart")
    tm, tm0 = report["phaseTimings"], report0["phaseTimings"]
    card_b = off_card(proc, "ingest (b)")
    parts["b_s"] = time.perf_counter() - t_b
    b = {"engine_instance": iid, "status": report["status"],
         "heldout_rmse": heldout, "factor_max_abs_diff": gap,
         "bit_identical": gap == 0.0, "local_twin": twin,
         "command_wall_s": train_wall_s,
         "read_s": tm["read_s"], "ingest_scan_s": tm.get("ingest_scan_s"),
         "ingest_build_s": tm.get("ingest_build_s"),
         "local_command_wall_s": train_wall0,
         "local_read_s": tm0["read_s"],
         "local_ingest_scan_s": tm0.get("ingest_scan_s"),
         "local_ingest_build_s": tm0.get("ingest_build_s"),
         "service_scans": m2.get(ok_key, 0.0) - m1.get(ok_key, 0.0),
         "service_coalesced": m2.get(co_key, 0.0) - m1.get(co_key, 0.0),
         "off_card": card_b}
    registry.close()
    seconds = time.perf_counter() - t_phase
    emit({"phase": "ingest_scan_train", "service": service, "a": a,
          "b": b, "parts_s": parts, "seconds": seconds})
    return {"proc": proc, "port": port, "service": service, "cli": cli_r,
            "iid": iid, "model": model, "row": row, "a": a, "b": b,
            "parts": parts, "seconds": seconds}


def ingest_serve_fold(torch, ft, dev, rng, project: dict) -> dict:
    """Phase ingest's second half, after phase quickstart (no earlier gate
    sees its events), from `project["ingest"]`: (c) (b)'s instance
    deployed with `--refresh-interval 2` and PIO_INGEST_SERVICE:
    INGEST_REQUESTS requests, each answer checked against the plain
    version on its factors, then a 192-event drip (`drip_events`)
    through the PEVLOG DAO, folded by the refresher through the service
    and served as `fold_gates` requires against this process's own fold
    on the card; K1 launches = plan calls = warmed buckets + drained
    chunks; the service counting the tick's scans, the deploy's
    `pio_ingest_remote_scans_total{outcome="fallback"}` 0. While that
    deploy starts: (e) `cli run` of a function in a temporary module
    returning `store.pair_columns` through the service, equal to the
    local read, and (d) `cli train` with PIO_INGEST_FALLBACK=off against
    a port where nothing listens (a dead service), which fails with
    IngestUnavailable. Then (d) ingestd SIGKILLed while it scans for a
    consumer in this process: the consumer's local scan gives the same
    columns, counted `outcome="fallback"`. ingestd never appears among
    the card's compute processes."""
    import importlib.util
    import socket
    import threading
    from predictionio_tpu_torch.core.workflow import (
        engine_params_from_instance)
    from predictionio_tpu_torch.data import store as pstore
    from predictionio_tpu_torch.data.storage import StorageRegistry
    from predictionio_tpu_torch.ingest.client import maybe_remote
    from predictionio_tpu_torch.models.recommendation import (
        RecommendationEngine)
    from predictionio_tpu_torch.obs import get_registry
    from predictionio_tpu_torch.streaming import scan_delta
    from predictionio_tpu_torch.streaming.updaters import FoldContext

    t_phase = time.perf_counter()
    state = project["ingest"]
    tmp, config, app_id = project["tmp"], project["config"], project["app_id"]
    proc, port, service, cli = (state[k] for k in ("proc", "port",
                                                   "service", "cli"))
    model, parts = state["model"], state["parts"]
    if proc.poll() is not None:
        fail(f"ingestd exited {proc.returncode}: {stderr_tail(proc)}")
    n_items = model.item_factors.shape[0]
    registry = StorageRegistry(config)
    events = registry.get_events()
    engine = RecommendationEngine.apply()
    _, _, (algo,), _ = engine.make_components(
        engine_params_from_instance(engine, state["row"]))
    queries = make_queries(torch, ft, dev, rng, model, INGEST_REQUESTS,
                           n_items)
    ok_key = 'pio_ingest_service_scans_total{outcome="ok"}'

    # (e) and (d)'s train with no fallback start beside the deploy
    t_c = time.perf_counter()
    (tmp / "ingest_probe.py").write_text(INGEST_PROBE)
    run_proc = cli.start("run", "ingest_probe.pairs")
    dead = socket.socket()          # bound, never listening: refused
    dead.bind(("127.0.0.1", 0))
    off_env = {**cli.env, "PIO_INGEST_FALLBACK": "off",
               "PIO_INGEST_SERVICE": f"127.0.0.1:{dead.getsockname()[1]}"}
    off_err = open(tmp / "train_fallback_off.err", "w+")
    off_proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", "train",
         "--engine-json", "engine_ingest.json"], cwd=tmp, env=off_env,
        stdout=subprocess.DEVNULL, stderr=off_err, text=True)
    _BACKGROUND.add(off_proc)
    # phase obs (c): the deploy traces at OBS_TRACE_SAMPLE, so that its
    # refresher's spans land in its ring
    traced = SimpleNamespace(env={**cli.env,
                                  "PIO_TRACE_SAMPLE": OBS_TRACE_SAMPLE})
    dep, dport, deploy_wall_s = start_deploy(
        tmp, traced, state["iid"], "--engine-json", "engine_ingest.json",
        "--refresh-interval", str(STREAM_INTERVAL_S))
    try:
        spec = importlib.util.spec_from_file_location(
            "ingest_probe", tmp / "ingest_probe.py")
        probe = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(probe)
        with env_set(PIO_INGEST_CACHE="off", PIO_INGEST_WORKERS="4"):
            want = probe.digest(pstore.pair_columns(registry, "ml1m",
                                                    event_names=["rate"]))
        got, run_wall_s = cli.finish(run_proc)
        wait_status(dport, dep, "the refresher's baseline",
                    lambda s: s["refresh"]["ticks"].get("baseline"), 120)
        answers0 = serve_http(dport, queries)
        m0 = http_metrics(port)
        wm_before = events.ingest_watermark(app_id)
        drip = drip_events(model, rng, time.time())
        t_drip = time.perf_counter()
        events.insert_batch(drip, app_id)
        wm_after = events.ingest_watermark(app_id)
        st = wait_status(dport, dep, "the drip's fold",
                         lambda s: s["refresh"]["ticks"].get("folded"), 120)
        seen_s = time.perf_counter() - t_drip
        answers1 = serve_http(dport, queries)
        st_end = http_status(dport)
        t_obs = time.perf_counter()
        spans = http_json(dport, "/traces.json")[1]["traces"]
        ingestd_obs = {path: http_json(port, path)[1]
                       for path in ("/profile.json", "/tsdb.json")}
        obs_read_s = time.perf_counter() - t_obs
        dm = http_metrics(dport)
        m1 = http_metrics(port)
    finally:
        stop_deploy(dep)
    if {k: got[k] for k in want} != want or got["ok"] != 1.0 or \
            got["fallback"] != 0.0:
        fail(f"ingest (e): cli run read {got}, the local read {want}")
    err0 = check_answers(torch, ft, dev, model, queries,
                         [b_["itemScores"] for b_, _ in answers0], n_items)
    with env_set(PIO_INGEST_WORKERS="4"):
        delta = scan_delta(events, app_id, None, wm_before, wm_after)
        fctx = FoldContext(store=events, app_id=app_id, channel_id=None,
                           since=wm_before, upto=wm_after,
                           ds_params={"app_name": "ml1m"})
        torch.cuda.synchronize()
        t = time.perf_counter()
        folded = algo.fold_in(model, delta, fctx)
        torch.cuda.synchronize()
        own_fold_s = time.perf_counter() - t
    ticks = st_end["refresh"]["ticks"]
    if ticks.get("baseline") != 1 or ticks.get("folded") != 1 or any(
            ticks.get(k) for k in ("rolled_back", "failed",
                                   "full_rebuild")):
        fail(f"ingest (c): refresher ticks {ticks}")
    if st_end["refresh"]["watermark"] != wm_after:
        fail("ingest (c): the served model's watermark is not the drip's")
    err1, untouched, unchanged = fold_gates(
        torch, ft, dev, queries, model, folded, delta.touched_users,
        delta.touched_items, answers0, answers1, n_items)
    gate = launch_gate("ingest (c)", st_end, 2 * INGEST_REQUESTS)
    remote_ok = dm.get('pio_ingest_remote_scans_total{outcome="ok"}', 0.0)
    fallbacks = dm.get('pio_ingest_remote_scans_total{outcome="fallback"}',
                       0.0)
    tick_scans = m1.get(ok_key, 0.0) - m0.get(ok_key, 0.0)
    if fallbacks != 0.0 or remote_ok < 3 or tick_scans < 3:
        fail(f"ingest (c): the deploy's remote scans ok {remote_ok}, "
             f"fallback {fallbacks}; the service scanned {tick_scans} "
             "times for the fold (want the delta, its re-scan and the "
             "histories)")
    folds = [e for e in spans if e["name"] == "refresh_fold"]
    if len(folds) != ticks["folded"] or any(e.get("error") for e in folds) \
            or any(e["kind"] != "background" for e in folds):
        fail(f"obs (c): {len(folds)} refresh_fold spans {folds[:2]} for "
             f"{ticks['folded']} folds counted")
    prof_c, tsdb_c = ingestd_obs["/profile.json"], ingestd_obs["/tsdb.json"]
    if not prof_c["running"] or tsdb_c["scrapes"] < 1 or any(
            k.startswith("pio_device_memory_bytes")
            for k in tsdb_c["series"]):
        fail(f"obs (c): ingestd's profiler running {prof_c['running']}, "
             f"{tsdb_c['scrapes']} scrapes, series "
             f"{sorted(tsdb_c['series'])[:20]}")
    card_c = off_card(proc, "ingest (c)")
    obs_c = {"refresh_fold_spans": len(folds),
             "refresh_tick_spans": sum(e["name"] == "refresh_tick"
                                       for e in spans),
             "folds_counted": ticks["folded"],
             "fold_span_ms": [e["duration_ms"] for e in folds],
             "ingestd_profiler_samples": prof_c["samples"],
             "ingestd_scrapes": tsdb_c["scrapes"],
             "ingestd_off_card": True, "seconds": obs_read_s}
    parts["c_s"] = time.perf_counter() - t_c
    c = {"requests": 2 * INGEST_REQUESTS, "drip_events": len(drip),
         "touched_users": len(delta.touched_users),
         "touched_items": len(delta.touched_items),
         "command_to_serving_s": deploy_wall_s,
         "seen_folded_after_s": seen_s,
         "tick_s": st["refresh"]["last_ticks"]["folded"],
         "freshness_s": st["refresh"]["freshness_s"],
         "own_fold_s": own_fold_s, "max_abs_err": max(err0, err1),
         "untouched_answers": untouched,
         "untouched_answers_identical": unchanged,
         "remote_scans_ok": remote_ok, "remote_fallbacks": fallbacks,
         "service_scans_for_the_fold": tick_scans,
         "latency_ms": latency_ms(answers1), **gate,
         "off_card": card_c, "obs_c": obs_c}
    e = {**got, "command_wall_s": run_wall_s}

    # (d) the train with no fallback, then a SIGKILL during a scan
    t_d = time.perf_counter()
    off_code = off_proc.wait(timeout=600)
    _BACKGROUND.discard(off_proc)
    dead.close()
    off_err.seek(0)
    off_tail = off_err.read()[-2000:]
    off_err.close()
    if off_code == 0 or "IngestUnavailable" not in off_tail:
        fail(f"ingest (d): with PIO_INGEST_FALLBACK=off `cli train` "
             f"exited {off_code}: {off_tail}")
    off_wait_s = time.perf_counter() - t_d
    scan_kw = dict(event_names=["rate"], value_spec={"rate": 2.0})
    fb = lambda: get_registry().value(      # noqa: E731
        "pio_ingest_remote_scans_total", outcome="fallback") or 0.0
    fb0, got_cols = fb(), {}
    t_k = time.perf_counter()
    with env_set(PIO_INGEST_SERVICE=service, PIO_INGEST_WORKERS="4"):
        th = threading.Thread(target=lambda: got_cols.update(
            cols=maybe_remote(events).scan_columns(app_id, **scan_kw)))
        th.start()
        t_end = time.perf_counter() + 30
        while True:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/ingest/scans.json",
                    timeout=30) as resp:
                if any(s["state"] == "running"
                       for s in json.loads(resp.read())["scans"]):
                    break
            if not th.is_alive() or time.perf_counter() > t_end:
                fail("ingest (d): the consumer's scan ended before ingestd "
                     "was seen scanning")
            time.sleep(0.002)
        os.killpg(proc.pid, signal.SIGKILL)
        killed_s = time.perf_counter() - t_k
        th.join(300)
        fallback_s = time.perf_counter() - t_k - killed_s
        local = events.scan_columns(app_id, **scan_kw)
    proc.wait(timeout=60)
    _BACKGROUND.discard(proc)
    cols = got_cols.get("cols")
    if cols is None or not (
            all(np.array_equal(getattr(cols, k), getattr(local, k))
                for k in ("entity_ix", "target_ix", "value", "t_us"))
            and cols.entities == local.entities
            and cols.targets == local.targets):
        fail("ingest (d): the fallback's columns differ from the local scan")
    if fb() != fb0 + 1.0:
        fail(f"ingest (d): fallbacks counted {fb() - fb0}, want 1")
    parts["d_s"] = time.perf_counter() - t_d
    d = {"killed_after_s": killed_s, "fallback_scan_s": fallback_s,
         "fallback_rows": int(local.n),
         "fallback_off_train_exit": off_code,
         "fallback_off_train_waited_s": off_wait_s}
    registry.close()
    seconds = time.perf_counter() - t_phase
    out = {"phase": "ingest", "service": service,
           "a": state["a"], "b": state["b"], "c": c, "e": e, "d": d,
           "parts_s": parts, "first_half_s": state["seconds"],
           "seconds": seconds, "launches": gate["launches"]}
    emit(out)
    return out


# -- phase 4g: the memory-pressure guard and the watchdog's beats --------------

PRESSURE_SOFT_MARGIN = 0.02   # watermarks above the server's card reading,
PRESSURE_HARD_MARGIN = 0.04   # as fractions of the card's memory
PRESSURE_STALL_S = 15.0       # the wedge: past the refresher's 11-s budget
PRESSURE_CLIENTS = 4
PRESSURE_SHED = 8             # new requests sent at the soft watermark
BEAT_ROLES = ("reactor", "drainer", "feedback", "tier-pager", "refresher",
              "joiner")
TRIM_TARGETS = ("tsdb", "trace", "quality", "tenant_keys", "ingest_cache")


class KeyedLoad:
    """PRESSURE_CLIENTS threads posting `queries` to `port` with the
    app's access key until stopped; each answer kept as [query index,
    status, body, Retry-After, t_send, t_recv]."""

    def __init__(self, port: int, key: str, queries):
        import threading
        self.port, self.key, self.queries = port, key, queries
        self.res, self._stop = [], threading.Event()
        self._threads = [threading.Thread(target=self._run, args=(n,),
                                          daemon=True)
                         for n in range(PRESSURE_CLIENTS)]

    def one(self, n: int) -> list:
        q = self.queries[n % len(self.queries)]
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}/queries.json?accessKey={self.key}",
            data=json.dumps(q).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        t = time.monotonic()
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                return [n % len(self.queries), resp.status,
                        json.loads(resp.read()), None, t, time.monotonic()]
        except urllib.error.HTTPError as e:
            return [n % len(self.queries), e.code, json.loads(e.read()),
                    e.headers.get("Retry-After"), t, time.monotonic()]

    def _run(self, n: int) -> None:
        while not self._stop.is_set():
            self.res.append(self.one(n))
            n += PRESSURE_CLIENTS

    def __enter__(self):
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for t in self._threads:
            t.join(120)


def phase_pressure(torch, ft, dev, rng, project: dict, card: str) -> dict:
    """Phase 4g: the memory-pressure guard and the watchdog's beats on
    servers in this process, over the ML-1M PEVLOG project. The project's
    instance is deployed here as `cli deploy --refresh-interval 2
    --feedback --tenancy on` would (refresher, feedback loop to an event
    server in this process, quality joiner, per-app keys), beside a
    tiered deploy of its model (`PIO_SERVE_TIER=on`, a page thread);
    keyed clients loop on the first. Gates, in order:
      - roles: the watchdog's `pio_thread_beat_age_seconds` carries every
        role of BEAT_ROLES, each beat live on these servers;
      - soft: the guard reads the card alone (its host limit 0), its
        watermarks set PRESSURE_SOFT_MARGIN and PRESSURE_HARD_MARGIN of
        the card above this process's reading; real device bytes
        allocated here cross the soft one: every trim target of
        TRIM_TARGETS counted in `pio_mem_trims_total` and releasing
        bytes, PRESSURE_SHED new requests answered 503 with Retry-After
        and counted `pio_shed_total{surface="memory"}`, a request in
        flight (held 1 s in its predict) answered right, /ready 200; the
        bytes freed, serving resumes;
      - stall: `thread.refresher.stall` wedges the refresher past its
        11-s budget: one stall, one restart, a drip of ratings folded by
        the new thread, and one refresher thread once the wedged one
        wakes;
      - hard: more device bytes cross the hard watermark: the drain fires
        once, /ready fails, the server stops;
      - a `cli ingestd` holds no /dev/nvidia* file.
    Every 200 before the drip is checked against the plain version; K1
    launches = plan calls = the served plan's warmed buckets + drained
    chunks + the tiered plan's calls."""
    from predictionio_tpu_torch.cli.main import deploy, deploy_instance
    from predictionio_tpu_torch.core.runtime import RuntimeContext
    from predictionio_tpu_torch.core.workflow import resolve_engine
    from predictionio_tpu_torch.data import store as pstore
    from predictionio_tpu_torch.data.eventserver import (EventServer,
                                                         EventServerConfig)
    from predictionio_tpu_torch.data.storage import StorageRegistry
    from predictionio_tpu_torch.obs import MetricsRegistry, get_registry
    from predictionio_tpu_torch.obs import trace
    from predictionio_tpu_torch.ops import topk
    from predictionio_tpu_torch.ops.als import ALSModel
    from predictionio_tpu_torch.resilience import faults
    from predictionio_tpu_torch.resilience.pressure import device_memory_frac
    from predictionio_tpu_torch.resilience.watchdog import watchdog
    from predictionio_tpu_torch.serving.server import FeedbackConfig
    from predictionio_tpu_torch.tenancy import TenancyConfig
    t_phase = time.perf_counter()
    tmp, config, cli = project["tmp"], project["config"], project["cli"]
    app_id, row, model = project["app_id"], project["row"], project["model"]
    key = project["app"]["accessKey"]
    n_items = model.item_factors.shape[0]
    reg = get_registry()
    registry = StorageRegistry(config)
    events = registry.get_events()
    # a prepared-cache entry of this process: the ingest-cache trim's
    pstore.pair_columns(registry, "ml1m", event_names=["rate"])
    queries = make_queries(torch, ft, dev, rng, model, 256, n_items)
    es = EventServer(EventServerConfig(ip="127.0.0.1", port=0), registry,
                     metrics=MetricsRegistry())
    es.start()
    trace.configure(sample=QUALITY_TRACE_SAMPLE)
    ft.LAUNCHES = 0
    topk.PLAN_CALLS = 0
    server = tiered = None
    blobs = []
    out = {"phase": "pressure", "card": card}
    try:
        with env_set(PIO_TSDB_INTERVAL_S=OBS_TSDB_INTERVAL_S):
            server = deploy_instance(
                resolve_engine("recommendation"), row,
                RuntimeContext(registry=registry, device=dev), port=0,
                batch_max=64, refresh_interval_s=STREAM_INTERVAL_S,
                feedback=FeedbackConfig("127.0.0.1", es.port, key),
                tenancy=TenancyConfig(enabled=True),
                metrics=MetricsRegistry())
        with env_set(PIO_SERVE_TIER="on", PIO_TIER_HOT_FRAC="0.25"):
            tiered = deploy(ALSModel(model.user_factors,
                                     model.item_factors.cpu(), model.users,
                                     model.items),
                            port=0, batch_max=64, metrics=MetricsRegistry())
        plan = server.deployment.algos[0]._serve_plan
        wait_status(server.port, SimpleNamespace(poll=lambda: None),
                    "the refresher's baseline",
                    lambda st: st["refresh"]["ticks"].get("baseline"), 60)
        load = KeyedLoad(server.port, key, queries)
        tload = KeyedLoad(tiered.port, "", queries)
        res_soft = []
        with load:
            # -- the roles, live on these servers under load
            own = set()
            with tload:
                end = time.perf_counter() + 2.5
                while time.perf_counter() < end:
                    own |= {b.role for b in server._own_beats()}
                    own |= {b.role for b in tiered._own_beats()}
                    time.sleep(0.01)
                watchdog().sweep()
            ages = {r: reg.value("pio_thread_beat_age_seconds", role=r)
                    for r in BEAT_ROLES}
            own |= {r.beat.role for r in server._httpd.reactors
                    if r.beat is not None and not r.beat.closed}
            if any(ages[r] is None for r in BEAT_ROLES) or \
                    set(BEAT_ROLES) - own:
                fail(f"pressure: beat ages {ages}, these servers' live "
                     f"roles {sorted(own)}")
            # -- soft
            guard = server._pressure
            guard.limit_bytes = 0          # the card's reading decides
            reading = device_memory_frac()
            guard.soft_frac = reading + PRESSURE_SOFT_MARGIN
            guard.hard_frac = reading + PRESSURE_HARD_MARGIN
            frac_of = getattr(torch.cuda, "get_per_process_memory_fraction",
                              lambda d: 1.0)
            limit = torch.cuda.get_device_properties(dev).total_memory * \
                frac_of(dev)
            trims0 = {t: (reg.value("pio_mem_trims_total", target=t) or 0,
                          reg.value("pio_mem_trimmed_bytes_total",
                                    target=t) or 0) for t in TRIM_TARGETS}
            sheds = lambda: prom_sum(prom(server.metrics.render()),  # noqa: E731
                                     'pio_shed_total{surface="memory"')
            shed0 = sheds()
            n0 = len(load.res)
            faults().arm("serve.predict", latency=1.0, times=1)
            inflight = []
            import threading
            th = threading.Thread(target=lambda: inflight.append(
                load.one(0)))
            th.start()
            time.sleep(0.2)
            blobs.append(torch.empty(int((PRESSURE_SOFT_MARGIN + 0.005)
                                         * limit), dtype=torch.uint8,
                                     device=dev))
            t_soft = time.perf_counter()
            end = t_soft + 10
            while guard.state != "soft" and time.perf_counter() < end:
                time.sleep(0.02)
            soft_after_s = time.perf_counter() - t_soft
            shed = [load.one(n) for n in range(PRESSURE_SHED)]
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{server.port}/ready",
                    timeout=30) as resp:
                ready_soft = resp.status
            th.join(60)
            soft_frac = guard.observed_frac()
            trims1 = {t: (reg.value("pio_mem_trims_total", target=t) or 0,
                          reg.value("pio_mem_trimmed_bytes_total",
                                    target=t) or 0) for t in TRIM_TARGETS}
            shed1 = sheds()
            blobs.pop()
            torch.cuda.empty_cache()
            end = time.perf_counter() + 10
            while guard.state != "ok" and time.perf_counter() < end:
                time.sleep(0.02)
            time.sleep(0.5)
            res_soft = list(load.res[n0:])
            resumed = load.one(1)
        if guard.state == "soft" or soft_frac is None or \
                soft_frac < guard.soft_frac:
            fail(f"pressure (soft): the guard {guard.detail()} read "
                 f"{soft_frac} after {soft_after_s:.2f} s")
        released = {t: trims1[t][1] - trims0[t][1] for t in TRIM_TARGETS}
        if any(trims1[t][0] != trims0[t][0] + 1 for t in TRIM_TARGETS) or \
                any(v <= 0 for v in released.values()):
            fail(f"pressure (soft): trims {trims0} -> {trims1}")
        if any(r[1] != 503 or not r[3] or "memory pressure" not in
               r[2].get("message", "") for r in shed) or \
                shed1 - shed0 < PRESSURE_SHED or ready_soft != 200:
            fail(f"pressure (soft): new requests {[r[1] for r in shed]}, "
                 f"sheds {shed1 - shed0}, /ready {ready_soft}")
        if not inflight or inflight[0][1] != 200 or resumed[1] != 200:
            fail(f"pressure (soft): in flight {inflight[:1]}, after the "
                 f"release {resumed[1]}")
        answered = [r for r in load.res + inflight + [resumed]
                    if r[1] == 200]
        others = [r for r in load.res if r[1] not in (200, 503)]
        if others or any(r[1] == 503 and "memory pressure" not in
                         r[2].get("message", "") for r in load.res):
            fail(f"pressure: answers other than 200 or the memory 503: "
                 f"{(others or load.res)[0][:3]}")
        err = check_answers(torch, ft, dev, model,
                            [queries[r[0]] for r in answered],
                            [r[2]["itemScores"] for r in answered], n_items)
        tres = [r for r in tload.res if r[1] != 200]
        if tres:
            fail(f"pressure: the tiered server answered {tres[0][:3]}")
        # -- stall: the refresher wedged past its budget, then a fold
        ref = server._refresher
        stalls0 = reg.value("pio_watchdog_stalls_total",
                            role="refresher") or 0
        restarts0 = reg.value("pio_thread_restarts_total",
                              role="refresher") or 0
        wedged = ref.threads()
        folded0 = ref.ticks.get("folded", 0)
        t_stall = time.perf_counter()
        faults().arm("thread.refresher.stall", latency=PRESSURE_STALL_S,
                     times=1)
        end = t_stall + PRESSURE_STALL_S + 20
        while (reg.value("pio_thread_restarts_total", role="refresher")
               or 0) <= restarts0 and time.perf_counter() < end:
            time.sleep(0.05)
        restarted_s = time.perf_counter() - t_stall
        drip = drip_events(model, rng, time.time())
        events.insert_batch(drip, app_id)
        end = time.perf_counter() + 120
        while ref.ticks.get("folded", 0) <= folded0 and \
                time.perf_counter() < end:
            time.sleep(0.05)
        folded_s = time.perf_counter() - t_stall
        end = time.perf_counter() + PRESSURE_STALL_S + 10
        while any(t.is_alive() for t in wedged) and \
                time.perf_counter() < end:
            time.sleep(0.05)
        threads = ref.threads()
        stalls = (reg.value("pio_watchdog_stalls_total", role="refresher")
                  or 0) - stalls0
        restarts = (reg.value("pio_thread_restarts_total", role="refresher")
                    or 0) - restarts0
        if stalls != 1 or restarts != 1 or \
                ref.ticks.get("folded", 0) != folded0 + 1 or \
                len(threads) != 1 or threads[0] in wedged or \
                ref.beat is None or ref.beat.degraded:
            fail(f"pressure (stall): {stalls} stalls, {restarts} restarts, "
                 f"ticks {ref.ticks}, {len(threads)} refresher threads")
        # -- hard
        fired = []
        guard.on_hard(lambda: fired.append(time.perf_counter()))
        t_hard = time.perf_counter()
        blobs.append(torch.empty(int((PRESSURE_HARD_MARGIN + 0.005)
                                     * limit), dtype=torch.uint8,
                                 device=dev))
        end = t_hard + 10
        while guard.state != "hard" and time.perf_counter() < end:
            time.sleep(0.02)
        ready_hard, detail = server.readiness()
        hard_frac = guard.observed_frac()
        end = time.perf_counter() + 60
        while server.is_running() and time.perf_counter() < end:
            time.sleep(0.05)
        time.sleep(2.5)                    # two more sweeps in hard
        drained_s = time.perf_counter() - t_hard
        stopped = not server.is_running()
        blobs.pop()
        torch.cuda.empty_cache()
        if guard.state != "hard" or ready_hard or len(fired) != 1 or \
                detail.get("memPressure", {}).get("state") != "hard" or \
                not stopped:
            fail(f"pressure (hard): state {guard.state}, /ready "
                 f"{ready_hard} {detail.get('memPressure')}, drains "
                 f"{len(fired)}, stopped {stopped}")
        members = member_calls(server)
        tplan = tiered.deployment.algos[0]._serve_plan
        launches, calls = ft.LAUNCHES, topk.PLAN_CALLS
        if not launches == calls or members["plan_calls"] != \
                members["expected_calls"]:
            fail(f"pressure: K1 launches {launches}, plan calls {calls}, "
                 f"the served plan's {members}")
    finally:
        faults().clear()
        trace.configure(sample=0.0)
        blobs.clear()
        for srv in (server, tiered):
            if srv is not None:
                srv.stop()
        es.shutdown()
    # -- ingestd holds no device file
    proc, iport = start_ingestd(tmp, cli)
    try:
        ingestd_metrics = len(http_metrics(iport))
        card_ingestd = off_card(proc, "pressure")
    finally:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        _BACKGROUND.discard(proc)
    registry.close()
    out.update({
        "roles": {r: ages[r] for r in BEAT_ROLES},
        "soft": {"reading_before": reading, "soft_frac": guard.soft_frac,
                 "hard_frac": guard.hard_frac, "read_at_soft": soft_frac,
                 "card_limit_bytes": limit,
                 "soft_after_s": soft_after_s,
                 "trims": {t: trims1[t][0] - trims0[t][0]
                           for t in TRIM_TARGETS},
                 "released_bytes": released,
                 "new_requests_shed": len(shed),
                 "memory_sheds_counted": shed1 - shed0,
                 "retry_after": shed[0][3], "ready": ready_soft,
                 "inflight_status": inflight[0][1],
                 "load_requests": len(res_soft),
                 "load_shed": sum(r[1] == 503 for r in res_soft)},
        "stall": {"stall_s": PRESSURE_STALL_S, "budget_s":
                  STREAM_INTERVAL_S * 3 + 5, "stalls": stalls,
                  "restarts": restarts, "restarted_after_s": restarted_s,
                  "drip_events": len(drip), "folded_after_s": folded_s,
                  "refresher_threads": len(threads)},
        "hard": {"read_at_hard": hard_frac, "drains": len(fired),
                 "ready": ready_hard, "stopped_after_s": drained_s},
        "answers_checked": len(answered), "max_abs_err": err,
        "tiered_requests": len(tload.res), "tiered_plan_calls": tplan.calls,
        "served_plan": members, "launches": launches, "plan_calls": calls,
        "ingestd_metrics_series": ingestd_metrics,
        "ingestd_off_card": card_ingestd,
        "seconds": time.perf_counter() - t_phase})
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


def sidecar_sizes(events, root: Path) -> dict:
    """PEVLOG's segment sidecars after an ingest: persisted now, their
    bytes on disk, the filters' sizes, and the Bloom digests the
    indexes remember (occurrences and distinct keys, the regrow's
    sizing input)."""
    events.c.close()                     # persists every dirty sidecar
    idx = sorted(root.rglob("*.idx"))
    ixs = list(events.c.index_cache.values())
    digests = [dg for ix in ixs for dg in ix.digests]
    return {"segments": len(idx),
            "bytes": sum(f.stat().st_size for f in idx),
            "max_bytes": max((f.stat().st_size for f in idx), default=0),
            "bloom_bits": sorted({ix.bits for ix in ixs}),
            "digests": sum(len(dg) for dg in digests),
            "distinct_digests": sum(len(set(dg)) for dg in digests)}


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
    defaults; the cooccurrence streams at 50,000 items): build, train
    (beside e-commerce's build and train), deploy, SP_REQUESTS queries. Gates: every answer equals
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
                         "events_per_s": ingest["events"] / ingest["seconds"],
                         "sidecars": sidecar_sizes(events, tmp / "pevlog")}
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

        def build_train(name):
            cli("build", "--engine-json", f"{name}.json")
            return cli("train", "--engine-json", f"{name}.json")

        # the two templates build and train side by side, one process
        # each, on the one store
        names = ("ecommerce", "similarproduct")
        with ThreadPoolExecutor(2) as pool:
            trained = dict(zip(names, pool.map(build_train, names)))
        for name in names:
            report, wall = trained[name]
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


# -- phase 16: the classification template ------------------------------------

# bench.py's BASELINE config 2 (bench_classification): 1,000,000 x 100,
# 4 classes; NB on class-conditional Poisson counts, the forest on a
# planted depth-2 rule with 10% flips (Bayes accuracy 0.925), 10 trees of
# depth 5 over 32 bins, every feature, seed 1
CLF_N, CLF_F, CLF_CLASSES = 1_000_000, 100, 4
CLF_TREES, CLF_DEPTH, CLF_BINS, CLF_SEED = 10, 5, 32, 1
CLF_SLICE = 100_000      # rows on which the card's forest meets the CPU's
CLF_STEPS = 200          # logistic regression's full-batch Adam steps
NB_TOL = 1e-5            # pi and theta against a float64 numpy fit
GAIN_TIE = 1e-6          # a differing split is allowed only at this margin
# logits of the card's logistic regression against the CPU port's, times
# max(1, the largest |logit|); tests/test_torch_classification.py holds
# the port against optax at the same bound
LOGREG_TOL = 1e-4
PREDICT_SIZES = (1, 8, 64, 256, 1024, 2048, 4096, 16_384, 100_000)
# phase (b): the quickstart's users (tests/test_classification.py:87-103's
# rule), cut from bench's 1,000,000 rows to 200,000 for the script's time
CLF_USERS, CLF_REQUESTS, CLF_CLIENTS, CLF_BP = 200_000, 256, 8, 20_000
CLF_T0_MS = 1_704_067_200_000
CLF_EVAL_FOLDS = 3

# The evaluation `cli eval` runs: Accuracy over 3 folds, NB and the forest
CLF_EVAL_MODULE = """
from predictionio_tpu_torch.core.evaluation import (EngineParamsGenerator,
                                                    Evaluation)
from predictionio_tpu_torch.core.params import EngineParams
from predictionio_tpu_torch.models import classification as clf

DS = ("", clf.DataSourceParams(app_name="clf", eval_k={folds}))
ClassificationEvaluation = Evaluation(
    engine=clf.ClassificationEngine.apply(), metric=clf.Accuracy())
ClassificationParams = EngineParamsGenerator([
    EngineParams(data_source_params=DS, algorithm_params_list=(
        ("naive", clf.NaiveBayesParams()),)),
    EngineParams(data_source_params=DS, algorithm_params_list=(
        ("forest", clf.RandomForestParams(num_trees=8, max_depth=4)),))])
"""


def classification_data(seed: int) -> dict:
    """`bench_classification`'s generator (bench.py:2754-2803) from
    `seed` (0 is bench's): NB's counts and split, then the forest's
    features, planted rule, flips and split, in bench's draw order."""
    rng = np.random.RandomState(seed)
    n, f = CLF_N, CLF_F
    theta = rng.dirichlet(np.ones(f) * 0.3, CLF_CLASSES)
    y = rng.randint(0, CLF_CLASSES, n)
    counts = rng.poisson(theta[y] * 40.0).astype(np.float32)
    test = rng.rand(n) < 0.1
    xf = rng.randn(n, f).astype(np.float32)
    rule = (xf[:, 3] > 0.2).astype(np.int64) * 2 + (xf[:, 17] > -0.1)
    flip = rng.rand(n) < 0.1
    yf = np.where(flip, rng.randint(0, 4, n), rule)
    trf = rng.rand(n) < 0.9
    return {"xtr": counts[~test], "ytr": y[~test], "xte": counts[test],
            "yte": y[test], "xf": xf, "yf": yf, "trf": trf}


def split_margins(torch, fo, hist, ranks, subset: int, impurity: str):
    """Per (tree, node): the best allowed gain and the gap to the second
    best, from a level's histogram [t, nd, f, B, C], by the gain formula
    of `ops.forest._select_splits`."""
    left = torch.cumsum(hist, dim=3)
    total = left[:, :, :, -1, :]
    right = total[:, :, :, None, :] - left
    nl, nr = left.sum(-1), right.sum(-1)
    parent = total[:, :, 0, :]
    imp_p = fo._impurity(parent, parent.sum(-1)[..., None], impurity)
    child = (nl * fo._impurity(left, nl[..., None], impurity)
             + nr * fo._impurity(right, nr[..., None], impurity)) \
        / torch.clamp(nl + nr, min=1e-9)
    gain = imp_p[:, :, None, None] - child
    gain[:, :, :, -1] = -float("inf")
    gain = torch.where((ranks < subset)[:, :, :, None], gain,
                       -float("inf"))
    top = torch.topk(gain.reshape(gain.shape[0], gain.shape[1], -1), 2,
                     dim=-1)
    return gain, top.values[..., 0], top.values[..., 0] - top.values[..., 1]


def forest_levels(torch, fo, dev, x, y, *, n_trees, depth, bins, subset,
                  impurity, seed, stop_at=None, timed=False):
    """`ops.forest.forest_train`'s level loop again from the same seed
    (the same draws, the same uploads), on `dev`: per level the splits
    and, with `timed`, CUDA-event ms of the histogram, the selection and
    the routing; up to `stop_at`, whose histogram and ranks it returns
    instead."""
    edges = fo.quantile_bins(x, bins)
    xb_np = fo.apply_bins(x, edges)
    classes, y_np = np.unique(y, return_inverse=True)
    c, (n, f) = max(len(classes), 2), x.shape
    gen = torch.Generator().manual_seed(seed)
    w = (torch.ones((1, n)) if n_trees == 1 else torch.poisson(
        torch.ones((n_trees, n)), generator=gen)).to(dev)
    xb = torch.from_numpy(xb_np).to(dev)
    fb_cols = xb.to(torch.int32) + torch.arange(
        f, dtype=torch.int32, device=dev)[None, :] * bins
    yd = torch.from_numpy(y_np.astype(np.int64)).to(dev)
    node = torch.zeros((n_trees, n), dtype=torch.int64, device=dev)
    levels = []
    for level in range(depth):
        nd = 1 << level
        ranks = fo.draw_ranks(gen, n_trees, nd, f).to(dev)
        kw = dict(n_nodes=nd, c=c, f=f, b=bins)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)] \
            if timed else None
        if timed:
            ev[0].record()
        hist = fo._histogram(node * c + yd[None, :], w, fb_cols, **kw)
        if level == stop_at:
            return hist, ranks
        if timed:
            ev[1].record()
        sf, sb = fo._select_splits(hist, ranks, subset=subset,
                                   impurity=impurity, **kw)
        if timed:
            ev[2].record()
        node = fo._route(xb, node, sf, sb)
        row = {"split_feature": sf.cpu().numpy(),
               "split_bin": sb.cpu().numpy()}
        if timed:
            ev[3].record()
            torch.cuda.synchronize()
            row.update(hist_ms=ev[0].elapsed_time(ev[1]),
                       select_ms=ev[1].elapsed_time(ev[2]),
                       route_ms=ev[2].elapsed_time(ev[3]))
        levels.append(row)
    return levels


def forest_agreement(torch, fo, card, cpu, x, y, *, subset: int,
                     impurity: str, seed: int) -> dict:
    """Two forests of one seed (the card's, the CPU's): equal splits and
    leaves, except that a tree may take another split where, at the
    first level it differs, each differing node's two best gains on the
    CPU lie within GAIN_TIE and the card's split is one of them; such a
    tree's deeper levels and leaves are then not compared. Fails
    otherwise; returns the counts."""
    t, depth = card.n_trees, card.max_depth
    ties, tied_trees = 0, set()
    for level in range(depth):
        cols = slice((1 << level) - 1, (1 << (level + 1)) - 1)
        diff = ((card.split_feature[:, cols] != cpu.split_feature[:, cols])
                | (card.split_bin[:, cols] != cpu.split_bin[:, cols]))
        diff[sorted(tied_trees)] = False
        if not diff.any():
            continue
        hist, ranks = forest_levels(
            torch, fo, torch.device("cpu"), x, y, n_trees=t, depth=depth,
            bins=card.bin_edges.shape[1] + 1, subset=subset,
            impurity=impurity, seed=seed, stop_at=level)
        gain, best, margin = split_margins(torch, fo, hist, ranks, subset,
                                           impurity)
        b = card.bin_edges.shape[1] + 1
        for tree, nd in zip(*np.nonzero(diff)):
            j = int(card.split_feature[tree, cols][nd]) * b + int(
                card.split_bin[tree, cols][nd])
            got = float(gain[tree, nd].reshape(-1)[j])
            if not (float(margin[tree, nd]) <= GAIN_TIE
                    and got >= float(best[tree, nd]) - GAIN_TIE):
                fail(f"forest: tree {tree} level {level} node {nd} splits "
                     "otherwise on the card than on the CPU with a gain "
                     f"margin {float(margin[tree, nd])}")
            ties += 1
            tied_trees.add(int(tree))
    same = [k for k in range(t) if k not in tied_trees]
    if not np.array_equal(card.leaf_class[same], cpu.leaf_class[same]):
        fail("forest: leaves differ between the card and the CPU")
    return {"trees": t, "identical_trees": len(same), "near_ties": ties}


def timed_route(fn, xb, reps: int) -> float:
    """Median ms of `fn(xb)` (each call ends on the host)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(xb)
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def predict_routes(model, x) -> dict:
    """Host loop and device traversal of one forest at PREDICT_SIZES
    queries up to len(x) (binned once; each device call uploads and
    fetches): median ms, queries/s, and the cells from which the card
    wins at every larger size measured."""
    from predictionio_tpu_torch.ops import forest as fo
    rows, crossover = [], None
    for q in [q for q in PREDICT_SIZES if q <= len(x)]:
        xb = fo.apply_bins(np.asarray(x[:q], np.float32), model.bin_edges)
        if not np.array_equal(model.predict_host(xb),
                              model.predict_device(xb)):
            fail(f"forest predict: host and device differ at {q} queries")
        reps = 20 if q <= 4096 else 5
        host = timed_route(model.predict_host, xb, reps)
        card = timed_route(model.predict_device, xb, reps)
        rows.append({"queries": q, "cells": q * model.n_trees,
                     "host_ms": host, "device_ms": card,
                     "host_qps": 1e3 * q / host,
                     "device_qps": 1e3 * q / card})
    for r in reversed(rows):
        if r["device_ms"] > r["host_ms"]:
            break
        crossover = r["cells"]
    return {"by_size": rows, "device_wins_from_cells": crossover,
            "host_crossover_cells": model.HOST_CROSSOVER_CELLS}


def classification_ops(torch, dev, card: str, seed: int) -> dict:
    """Phase classification (a): NB, the forest and logistic regression
    at bench.py's BASELINE config 2 on the card."""
    from predictionio_tpu_torch.ops import forest as fo
    from predictionio_tpu_torch.ops import logreg as lo
    from predictionio_tpu_torch.ops import naive_bayes as nb

    bw, _, _ = peaks(card)
    t0 = time.perf_counter()
    d = classification_data(seed)
    out = {"data_s": time.perf_counter() - t0, "rows": CLF_N,
           "features": CLF_F, "classes": CLF_CLASSES}

    # -- naive Bayes --------------------------------------------------------
    xtr, ytr, xte, yte = d["xtr"], d["ytr"], d["xte"], d["yte"]
    upload = nb.narrow_features(xtr).dtype
    if upload != np.uint8:
        fail(f"NB uploads {upload}, not uint8")
    nb.nb_train(xtr[:1000], ytr[:1000], 1.0, device=dev)   # cuBLAS set-up
    tm = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = nb.nb_train(xtr, ytr, 1.0, device=dev, timings=tm)
    nb_s = time.perf_counter() - t0
    nb_peak = torch.cuda.max_memory_allocated()
    counts = np.bincount(ytr, minlength=CLF_CLASSES)
    sums = np.stack([xtr[ytr == k].sum(0, dtype=np.float64)
                     for k in range(CLF_CLASSES)])
    pi64 = np.log(counts / len(ytr))
    th64 = np.log((sums + 1.0) / (sums.sum(1, keepdims=True) + CLF_F))
    nb_err = max(float(np.abs(model.pi - pi64).max()),
                 float(np.abs(model.theta - th64).max()))
    if not nb_err <= NB_TOL:
        fail(f"NB: pi / theta {nb_err} from the float64 fit")
    acc = float((nb.nb_predict(model, xte) == yte).mean())
    oacc = float(((xte @ th64.T + pi64).argmax(1) == yte).mean())
    if abs(acc - oacc) > 0.005:
        fail(f"NB accuracy {acc} vs the closed form's {oacc}")
    # a uint16 upload widens on the card: its fit against float64 too
    small = np.random.RandomState(seed + 1).randint(
        0, 1000, (2000, 8)).astype(np.float32)
    small_y = (small[:, 0] > 500).astype(np.int64)
    m16 = nb.nb_train(small, small_y, 1.0, device=dev)
    s64 = np.stack([small[small_y == k].sum(0, dtype=np.float64)
                    for k in range(2)])
    err16 = max(float(np.abs(m16.pi - np.log(
        np.bincount(small_y) / len(small_y))).max()), float(np.abs(
            m16.theta - np.log((s64 + 1.0) / (
                s64.sum(1, keepdims=True) + 8))).max()))
    if nb.narrow_features(small).dtype != np.uint16 or not err16 <= NB_TOL:
        fail(f"NB at a uint16 upload: pi / theta {err16} from float64")
    out["naive_bayes"] = {
        "train_s": nb_s, **tm, "upload_dtype": str(upload),
        "upload_bytes": int(xtr.size), "accuracy": acc,
        "closed_form_accuracy": oacc, "max_abs_err_vs_float64": nb_err,
        "peak_device_bytes": nb_peak, "uint16_max_abs_err": err16}

    # -- the forest ---------------------------------------------------------
    xf, yf, trf = d["xf"], d["yf"], d["trf"]
    x, y = xf[trf], yf[trf]
    kw = dict(n_trees=CLF_TREES, max_depth=CLF_DEPTH, max_bins=CLF_BINS,
              feature_subset_strategy="all", seed=CLF_SEED)
    subset = fo._subset_size("all", CLF_F, CLF_TREES)
    xs, ys = x[:CLF_SLICE], y[:CLF_SLICE]
    t0 = time.perf_counter()
    card_small = fo.forest_train(xs, ys, **kw, device=dev)
    card_small_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_small = fo.forest_train(xs, ys, **kw, device="cpu")
    cpu_small_s = time.perf_counter() - t0
    agreement = forest_agreement(torch, fo, card_small, cpu_small, xs, ys,
                                 subset=subset, impurity="gini",
                                 seed=CLF_SEED)
    tm = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    forest = fo.forest_train(x, y, **kw, device=dev, timings=tm)
    forest_s = time.perf_counter() - t0
    forest_peak = torch.cuda.max_memory_allocated()
    facc = float((forest.predict(xf[~trf]) == yf[~trf]).mean())
    if not facc >= 0.90:
        fail(f"forest held-out accuracy {facc} is below 0.90")
    xb_te = fo.apply_bins(xf[~trf], forest.bin_edges)
    if not np.array_equal(forest.predict_host(xb_te),
                          forest.predict_device(xb_te)):
        fail("forest: host and device predict disagree on the test rows")
    levels = forest_levels(torch, fo, dev, x, y, n_trees=CLF_TREES,
                           depth=CLF_DEPTH, bins=CLF_BINS, subset=subset,
                           impurity="gini", seed=CLF_SEED, timed=True)
    for lv, row in enumerate(levels):
        cols = slice((1 << lv) - 1, (1 << (lv + 1)) - 1)
        if not (np.array_equal(row.pop("split_feature"),
                               forest.split_feature[:, cols])
                and np.array_equal(row.pop("split_bin"),
                                   forest.split_bin[:, cols])):
            fail(f"forest level {lv}: the timed replay split otherwise")
        adds = CLF_TREES * len(y) * CLF_F
        # each scatter-add reads a 4-byte key and a 4-byte weight
        row.update(level=lv, scatter_adds=adds,
                   hist_bound_ms=1e3 * adds * 8 / bw,
                   hist_share=row["hist_ms"] / (
                       row["hist_ms"] + row["select_ms"] + row["route_ms"]))
    out["forest"] = {
        "trees": CLF_TREES, "depth": CLF_DEPTH, "bins": CLF_BINS,
        "train_rows": len(y), "train_s": forest_s, **tm,
        "peak_device_bytes": forest_peak, "heldout_accuracy": facc,
        "bayes_accuracy": 0.925, "levels": levels,
        "slice": {"rows": CLF_SLICE, "card_s": card_small_s,
                  "cpu_s": cpu_small_s, **agreement},
        "predict_routes": predict_routes(forest, xf[~trf])}

    # -- logistic regression ------------------------------------------------
    t0 = time.perf_counter()
    lr_card = lo.logreg_train(x, y, steps=CLF_STEPS, device=dev)
    lr_s = time.perf_counter() - t0
    # the loop alone on the card: the standardized upload, `_fit`
    fs = torch.from_numpy(((x - x.mean(0)) / (x.std(0) + 1e-8)).astype(
        np.float32)).to(dev)
    cix = torch.from_numpy(np.searchsorted(np.unique(y), y).astype(
        np.int32)).to(dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    lo._fit(fs, cix, n_classes=CLF_CLASSES, steps=CLF_STEPS, lr=0.1,
            reg=1e-4)
    end.record()
    torch.cuda.synchronize()
    loop_ms = start.elapsed_time(end)
    del fs, cix
    t0 = time.perf_counter()
    lr_cpu = lo.logreg_train(x, y, steps=CLF_STEPS, device="cpu")
    lr_cpu_s = time.perf_counter() - t0
    xt = xf[~trf]
    lc, lh = xt @ lr_card.w + lr_card.b, xt @ lr_cpu.w + lr_cpu.b
    lr_err = float(np.abs(lc - lh).max())
    if not lr_err <= LOGREG_TOL * max(1.0, float(np.abs(lh).max())):
        fail(f"logistic regression: card logits {lr_err} from the CPU's")
    out["logreg"] = {
        "steps": CLF_STEPS, "train_s": lr_s, "cpu_train_s": lr_cpu_s,
        "loop_ms": loop_ms, "loop_ms_per_step": loop_ms / CLF_STEPS,
        "max_abs_logit_err": lr_err,
        "max_abs_logit": float(np.abs(lh).max()),
        "heldout_accuracy": float(
            (lo.logreg_predict(lr_card, xt) == yf[~trf]).mean())}
    return out


def classification_users(seed: int) -> dict:
    """CLF_USERS users in the quickstart's structure: plan = i % 2; attr0
    ~ Poisson(7) for plan 0 and Poisson(1) otherwise, attr2 the other way
    round, attr1 ~ Poisson(2); then the queries' attributes drawn alike
    (CLF_REQUESTS for the deploy, CLF_BP for batchpredict)."""
    rng = np.random.default_rng(seed + 16)

    def draw(n, plan):
        return np.stack([np.where(plan == 0, rng.poisson(7, n),
                                  rng.poisson(1, n)),
                         rng.poisson(2, n),
                         np.where(plan == 1, rng.poisson(7, n),
                                  rng.poisson(1, n))], axis=1)

    plan = np.arange(CLF_USERS) % 2
    nq = CLF_REQUESTS + CLF_BP
    return {"attrs": draw(CLF_USERS, plan), "plan": plan,
            "queries": draw(nq, rng.integers(0, 2, nq))}


def classification_ingest(events, app_id: int, u: dict) -> dict:
    """One `$set` per user into the port's PEVLOG DAO in process
    (`insert_batch` of 50,000)."""
    from predictionio_tpu_torch.data.event import DataMap, Event, from_millis
    t0 = time.perf_counter()
    a, plan = u["attrs"].tolist(), u["plan"].tolist()
    for lo in range(0, CLF_USERS, 50_000):
        events.insert_batch([Event(
            event="$set", entity_type="user", entity_id=f"u{n}",
            properties=DataMap({"attr0": a[n][0], "attr1": a[n][1],
                                "attr2": a[n][2], "plan": float(plan[n])}),
            event_time=from_millis(CLF_T0_MS + n))
            for n in range(lo, min(lo + 50_000, CLF_USERS))], app_id)
    return {"events": CLF_USERS, "seconds": time.perf_counter() - t0}


def phase_classification(torch, ft, dev, seed: int, card: str) -> dict:
    """The classification template on the card.

    (a) `classification_ops`: NB, the forest and logistic regression at
    bench.py's BASELINE config 2.
    (b) The template through the command line over SQLITE metadata and
    PEVLOG events: `classification_users`' 200,000 `$set` events, `cli
    build`, `train` (forest 8 x depth 4, naive, logreg), `deploy` and
    CLF_REQUESTS /queries.json from CLF_CLIENTS threads; `cli
    batchpredict` of CLF_BP queries, and the same lines through
    `core.batchpredict` in this process with the forest's device
    traversal counted; `cli eval` (Accuracy, 3 folds, naive and forest).
    Gates: COMPLETED; every answer equals the forest's `batch_predict` on
    the models read back, on the CPU; each algorithm's answers on the
    card equal its CPU answers; the served batches stay on the forest's
    host loop and batchpredict's chunks take its device traversal; NB's
    eval accuracy above 0.85 and the forest's at least NB's - 0.05; no
    K1 launch anywhere in the phase."""
    from predictionio_tpu_torch.core.batchpredict import (load_deployment,
                                                          predict_lines)
    from predictionio_tpu_torch.core.runtime import RuntimeContext
    from predictionio_tpu_torch.data.storage import (
        EngineInstanceStatus, EvaluationInstanceStatus, StorageRegistry)
    from predictionio_tpu_torch.models import classification as clf
    from predictionio_tpu_torch.ops import forest as fo

    t_phase = time.perf_counter()
    k1_before = (ft.LAUNCHES, ft.SHARD_LAUNCHES)
    out = {"phase": "classification",
           "ops": classification_ops(torch, dev, card, seed)}
    u = classification_users(seed)
    engine = clf.ClassificationEngine.apply()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_clf_") as tmp:
        tmp = Path(tmp)
        config = {"PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
                  "PIO_STORAGE_SOURCES_DB_PATH": str(tmp / "pio.db"),
                  "PIO_STORAGE_SOURCES_PEV_TYPE": "PEVLOG",
                  "PIO_STORAGE_SOURCES_PEV_PATH": str(tmp / "pevlog"),
                  "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
                  "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "PEV",
                  "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB"}
        cli = cli_runner(tmp, config, PIO_INGEST_WORKERS="4")
        app, _ = cli("app", "new", "clf")
        registry = StorageRegistry(config)
        events = registry.get_events()
        events.init(app["id"])
        ingest = classification_ingest(events, app["id"], u)
        out["ingest"] = {**ingest,
                         "events_per_s": ingest["events"] / ingest["seconds"]}
        (tmp / "engine.json").write_text(json.dumps({
            "id": "classification", "engineFactory": "classification",
            "datasource": {"params": {"app_name": "clf"}},
            "algorithms": [
                {"name": "forest", "params": {"num_trees": 8,
                                              "max_depth": 4}},
                {"name": "naive", "params": {}},
                {"name": "logreg", "params": {}}]}))
        _, build_s = cli("build")
        report, train_s = cli("train")
        if report["status"] != EngineInstanceStatus.COMPLETED:
            fail(f"the classification instance is {report['status']}")
        iid = report["engineInstanceId"]
        models, row = read_models(config, iid, dev)
        names = [a["name"] for a in json.loads(row.algorithms_params)]
        cpu_models = [m.to("cpu") for m in models]
        algos = [engine.algorithm_classes[n]() for n in names]
        qs = [{"attr0": int(a), "attr1": int(b), "attr2": int(c)}
              for a, b, c in u["queries"].tolist()]
        queries = [(i, clf.Query(**q)) for i, q in enumerate(qs)]
        per_algo = {}
        for name, algo, m, mc in zip(names, algos, models, cpu_models):
            on_card = [p.label for _, p in algo.batch_predict(m, queries)]
            on_cpu = [p.label for _, p in algo.batch_predict(mc, queries)]
            if on_card != on_cpu:
                fail(f"{name}: the card's answers differ from the CPU's")
            per_algo[name] = {"answers_checked": len(queries),
                              "device": m.device}
        want = [p.label for _, p in algos[0].batch_predict(cpu_models[0],
                                                           queries)]
        out["train"] = {"engine_instance": iid, "build_wall_s": build_s,
                        "command_wall_s": train_s,
                        **report["phaseTimings"], "algorithms": per_algo}

        proc, port, deploy_s = start_deploy(tmp, cli, iid,
                                            "--engine-instance-id", iid)
        try:
            t0 = time.perf_counter()
            answers = serve_http(port, qs[:CLF_REQUESTS], CLF_CLIENTS)
            wall = time.perf_counter() - t0
            status = http_status(port)
        finally:
            stop_deploy(proc)
        got = [body["label"] for body, _ in answers]
        if got != want[:CLF_REQUESTS]:
            fail("deploy: /queries.json answers differ from the forest's "
                 "batch_predict on the models read back, on the CPU")
        biggest = max(int(k) for k in status["batch_sizes"])
        trees = models[0].n_trees
        if status["kernel_launches"]["fused_topk"] or \
                biggest * trees >= fo.ForestModel.HOST_CROSSOVER_CELLS:
            fail(f"deploy: K1 launches {status['kernel_launches']}, "
                 f"largest batch {biggest} x {trees} trees")
        out["serve"] = {
            "requests": CLF_REQUESTS, "clients": CLF_CLIENTS,
            "answers_checked": CLF_REQUESTS, "wall_s": wall,
            "qps": CLF_REQUESTS / wall, "latency_ms": latency_ms(answers),
            "batch_sizes": status["batch_sizes"],
            "forest_route": "host", "devices": status["devices"],
            "deploy": {"command_to_serving_s": deploy_s,
                       **status["deploy_timings"]},
            "k1_launches": status["kernel_launches"]["fused_topk"]}

        # the eval's process runs beside batchpredict
        (tmp / "clf_eval.py").write_text(CLF_EVAL_MODULE.format(
            folds=CLF_EVAL_FOLDS))
        eval_proc = cli.start("eval", "clf_eval.ClassificationEvaluation",
                              "clf_eval.ClassificationParams")
        lines = [json.dumps(q) for q in qs[CLF_REQUESTS:]]
        (tmp / "bp_in.jsonl").write_text("\n".join(lines) + "\n")
        bp, bp_wall = cli("batchpredict", "--input", "bp_in.jsonl",
                          "--output", "bp_out.jsonl")
        out_lines = (tmp / "bp_out.jsonl").read_text().splitlines()
        rows = [json.loads(x) for x in out_lines]
        if bp["predictions"] != CLF_BP or bp["engineInstanceId"] != iid or \
                [r["query"] for r in rows] != qs[CLF_REQUESTS:] or \
                [r["prediction"]["label"] for r in rows] != \
                want[CLF_REQUESTS:]:
            fail(f"batchpredict printed {bp}; its lines are not the "
                 "queries in order with the forest's CPU answers")
        traversals = []
        real = fo._predict_device

        def counted(xb, *a, **kw):
            traversals.append(int(xb.shape[0]))
            return real(xb, *a, **kw)

        dep = load_deployment(engine, row, RuntimeContext(
            registry=registry, device=dev))
        fo._predict_device = counted
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = list(predict_lines(dep, lines, chunk_size=BP_CHUNK))
            bp_s = time.perf_counter() - t0
        finally:
            fo._predict_device = real
        sizes = [min(BP_CHUNK, CLF_BP - lo)
                 for lo in range(0, CLF_BP, BP_CHUNK)]
        on_card = [q for q in sizes
                   if q * trees >= fo.ForestModel.HOST_CROSSOVER_CELLS]
        if again != out_lines or not on_card or traversals != on_card:
            fail(f"batchpredict in process: same lines {again == out_lines},"
                 f" device traversals {traversals} for chunks {sizes}")
        out["batchpredict"] = {
            "queries": CLF_BP, "command_wall_s": bp_wall,
            "command_queries_per_s": CLF_BP / bp_wall, "in_process_s": bp_s,
            "in_process_queries_per_s": CLF_BP / bp_s,
            "chunk": BP_CHUNK, "device_traversals": len(traversals),
            "host_chunks": len(sizes) - len(on_card)}

        printed, eval_wall = cli.finish(eval_proc)
        inst = registry.get_meta_data_evaluation_instances().get(
            printed["evaluationInstanceId"])
        results = json.loads(inst.evaluator_results_json)["results"] \
            if inst is not None else []
        if inst is None or inst.status != \
                EvaluationInstanceStatus.COMPLETED or len(results) != 2:
            fail(f"the evaluation instance: {inst}")
        nb_acc, rf_acc = (r["score"] for r in results)
        if not (nb_acc > 0.85 and rf_acc >= nb_acc - 0.05):
            fail(f"eval accuracy: naive {nb_acc}, forest {rf_acc}")
        tm = inst.runtime_conf["phase_timings"]
        out["eval"] = {"folds": CLF_EVAL_FOLDS, "naive": nb_acc,
                       "forest": rf_acc, "command_wall_s": eval_wall,
                       "read_s": tm.get("read_s"),
                       "per_fold": tm.get("folds"),
                       "peak_device_bytes": inst.runtime_conf.get(
                           "peak_device_bytes")}
        out["template_forest_routes"] = predict_routes(
            models[0], u["queries"].astype(np.float32))
        registry.close()
    if (ft.LAUNCHES, ft.SHARD_LAUNCHES) != k1_before:
        fail("K1 or K2 launched during phase classification")
    out["k1_launches"] = out["serve"]["k1_launches"]
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


# the neural phase: bench.py's bench_twotower (bench.py:3478-3527) and
# bench_seqrec (bench.py:3530-3585) at their data and widths
TT_USERS, TT_ITEMS, TT_EVENTS = 5_000, 2_000, 200_000
TT_EMB, TT_HIDDEN, TT_OUT, TT_BATCH, TT_EPOCHS = 64, 128, 64, 4_096, 10
SR_USERS, SR_ITEMS, SR_SEQ = 20_000, 1_000, 32
SR_DIM, SR_HEADS, SR_LAYERS, SR_BATCH, SR_EPOCHS = 64, 2, 2, 256, 10
# the seqrec template's store: bench_seqrec's 20,000 users, each user's
# events on one of SR_DAYS days (a month of PEVLOG's daily segments)
SR_DAYS = 30
NEURAL_T0_MS = 1_704_067_200_000        # 2024-01-01
PARITY_STEPS = 20
# the card's step losses against the CPU port's, relative: the float32
# runs read 1.8e-7 to 3.0e-7 (NVIDIA H100 80GB HBM3, 700 W); the
# lower-precision controls of `step_parity` must read above it
STEP_RTOL = 3e-6
ATTN_TOL = 2e-5         # attention on the card against float64
ATTN_GRAD_TOL = 1e-4    # x the float64 gradient's largest magnitude
NEURAL_REQUESTS, NEURAL_CLIENTS, NEURAL_BP = 256, 8, 2_000
# each client's pause during the rebuild: unpaced, 8 clients held the
# server's interpreter lock so that a 2.6-s two-tower retrain took 43.5 s
# (beside an NVIDIA H100 80GB HBM3 at 700 W)
NEURAL_PACE_S = 0.05
NEURAL_TOL = 1e-5       # served scores against score_and_rank on the CPU


def twotower_data() -> dict:
    """bench_twotower's generator: 5,000 users in 10 blocks of taste,
    200,000 (user, item) events, 80% inside the user's block, 5% held
    out; the held-out sample of 3,000 drawn after, as bench.py draws
    it."""
    rng = np.random.RandomState(3)
    n_blocks = 10
    gu = rng.randint(0, n_blocks, TT_USERS)
    u = rng.randint(0, TT_USERS, TT_EVENTS).astype(np.int32)
    block = np.where(rng.rand(TT_EVENTS) < 0.8, gu[u],
                     rng.randint(0, n_blocks, TT_EVENTS))
    i = (block * (TT_ITEMS // n_blocks)
         + rng.randint(0, TT_ITEMS // n_blocks, TT_EVENTS)).astype(np.int32)
    held = rng.rand(TT_EVENTS) < 0.05
    held_ix = np.flatnonzero(held)
    sample = rng.choice(held_ix, min(3000, len(held_ix)), replace=False)
    return {"u": u, "i": i, "held": held, "sample": sample}


def seqrec_data(n_users: int) -> dict:
    """bench_seqrec's generator: per user 8-63 events along the planted
    item chain (item + 1 mod 1,000, 10% noise of up to 6 steps), its
    sequences (seq_len 32) and a 10% held-out split of them."""
    from predictionio_tpu_torch.ops.seqrec import build_sequences
    rng = np.random.RandomState(5)
    lens = rng.randint(8, 2 * SR_SEQ, n_users)
    total = int(lens.sum())
    u = np.repeat(np.arange(n_users), lens)
    starts = rng.randint(0, SR_ITEMS, n_users)
    offs = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    noise = np.where(rng.rand(total) < 0.1, rng.randint(0, 7, total), 0)
    i = (np.repeat(starts, lens) + offs + noise) % SR_ITEMS
    seqs, targets = build_sequences(u, i, offs, n_items=SR_ITEMS,
                                    seq_len=SR_SEQ)
    held = rng.rand(len(seqs)) < 0.1
    return {"u": u, "i": i, "offs": offs, "seqs": seqs, "targets": targets,
            "held": held}


def neural_attention(torch, dev, seed: int) -> dict:
    """The port's attention on the card against float64 on the CPU, at
    seqrec's width (B 256, S 32, H 2, Dh 32) and at S 512 (B 16): causal
    or not, with and without a left-padded kv_mask (a row per padding
    length, one unpadded). Gates: forward within ATTN_TOL, gradients of
    sum(out^2) finite and within ATTN_GRAD_TOL x the largest float64
    gradient, the blockwise recurrence (4 blocks) within ATTN_TOL, every
    dead row (a padding query under the causal mask) exactly 0 in both.
    Times the reference, the blockwise form and SDPA (for the record)
    on the unmasked, non-causal case by CUDA events."""
    import torch.nn.functional as F

    from predictionio_tpu_torch.ops import attention as at
    gen = torch.Generator().manual_seed(seed)
    H, Dh = SR_HEADS, SR_DIM // SR_HEADS
    out = {"tol": ATTN_TOL, "grad_tol": ATTN_GRAD_TOL, "shapes": []}
    for B, S in ((SR_BATCH, SR_SEQ), (16, 512)):
        q, k, v = (torch.randn((B, S, H, Dh), generator=gen)
                   for _ in range(3))
        pad = torch.arange(B) % S
        mask = torch.arange(S)[None, :] >= pad[:, None]
        dead = (torch.arange(S)[None, :] < pad[:, None])     # [B, S]
        row = {"B": B, "S": S, "H": H, "Dh": Dh, "cases": []}
        for causal in (False, True):
            for masked in (False, True):
                m = mask if masked else None
                md = m.to(dev) if masked else None
                qd, kd, vd = (t.to(dev).requires_grad_() for t in (q, k, v))
                o = at.attention_reference(qd, kd, vd, causal=causal,
                                           kv_mask=md)
                g = torch.autograd.grad((o ** 2).sum(), (qd, kd, vd))
                q64, k64, v64 = (t.double().requires_grad_()
                                 for t in (q, k, v))
                o64 = at.attention_reference(q64, k64, v64, causal=causal,
                                             kv_mask=m)
                g64 = torch.autograd.grad((o64 ** 2).sum(),
                                          (q64, k64, v64))
                with torch.no_grad():
                    bw = at.blockwise_attention(
                        qd, kd, vd, n_blocks=4, causal=causal, kv_mask=md)
                o64 = o64.detach()
                err = float((o.detach().cpu().double() - o64).abs().max())
                bw_err = float((bw.cpu().double() - o64).abs().max())
                gmax = max(float(x.abs().max()) for x in g64)
                gerr = max(float((a.cpu().double() - b).abs().max())
                           for a, b in zip(g, g64))
                finite = all(bool(torch.isfinite(x).all()) for x in g)
                dead_max = 0.0
                if causal and masked:
                    dead_max = max(
                        float(o.detach().cpu()[dead].abs().max()),
                        float(bw.cpu()[dead].abs().max()),
                        float(o64[dead].abs().max()))
                case = {"causal": causal, "masked": masked,
                        "max_abs_err": err, "blockwise_max_abs_err": bw_err,
                        "grad_max_abs_err": gerr, "grad_max": gmax,
                        "dead_rows": int(dead.sum()) if causal and masked
                        else 0, "dead_max_abs": dead_max}
                if not (err <= ATTN_TOL and bw_err <= ATTN_TOL and finite
                        and gerr <= ATTN_GRAD_TOL * max(1.0, gmax)
                        and dead_max == 0.0):
                    fail(f"attention B {B} S {S}: {case}")
                row["cases"].append(case)
        qd, kd, vd = (t.to(dev) for t in (q, k, v))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (qd, kd, vd))
        with torch.no_grad():
            row["ms"] = time_ms(
                torch, lambda: at.attention_reference(qd, kd, vd), 50)
            row["blockwise_ms"] = time_ms(
                torch, lambda: at.blockwise_attention(qd, kd, vd,
                                                      n_blocks=4), 20)
            row["sdpa_ms"] = time_ms(
                torch, lambda: F.scaled_dot_product_attention(qt, kt, vt),
                50)
            sd = F.scaled_dot_product_attention(qt, kt, vt).transpose(1, 2)
            row["sdpa_max_abs_diff"] = float(
                (sd - at.attention_reference(qd, kd, vd)).abs().max())
        out["shapes"].append(row)
    return out


class StepClock:
    """A trainer's `on_step` hook that times its steady state, every
    epoch after the first: a CUDA event and the host clock once step
    `skip - 1` is enqueued and once the last one is, so that the card's
    ms per step and the host's enqueue ms per step cover the same steps
    of the very call whose losses are gated (nothing syncs between)."""

    def __init__(self, torch, skip: int, n_steps: int):
        self.torch, self.skip, self.last = torch, skip, n_steps - 1
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.t0 = self.t1 = 0.0

    def __call__(self, i: int) -> None:
        if i == self.skip - 1:
            self.start.record()
            self.t0 = time.perf_counter()
        elif i == self.last:
            self.end.record()
            self.t1 = time.perf_counter()

    def report(self) -> dict:
        self.torch.cuda.synchronize()
        n = self.last + 1 - self.skip
        return {"timed_steps": n,
                "ms_per_step": self.start.elapsed_time(self.end) / n,
                "host_enqueue_ms_per_step": 1e3 * (self.t1 - self.t0) / n}


def profiled_epoch(torch, train_epoch, steps: int) -> dict:
    """One call of the trainer over one epoch under `torch.profiler`,
    device activity only (its uploads, set-up and final copy-out
    included; the trainer is warm from the timed call): device ms and
    operations per step and the card's busy share, a lower bound (the
    profiler's own host cost inflates the wall time)."""
    prof = profile_calls(torch, train_epoch, 1, top=8, warm=0,
                         host_ops=False)
    return {"steps": steps, "busy_share": prof["busy_share"],
            "wall_ms_per_step": prof["wall_ms"] / steps,
            "device_ms_per_step": prof["device_ms"] / steps,
            "operations_per_step": prof["kernels_per_call"] / steps,
            "kernels": prof["kernels"]}


def max_rel(card_losses, cpu_losses) -> float:
    card = np.array([float(x) for x in card_losses[:PARITY_STEPS]])
    cpu = np.array([float(x) for x in cpu_losses])
    if len(card) != PARITY_STEPS or not np.isfinite(card).all():
        return float("inf")
    return float(np.max(np.abs(card - cpu) / np.abs(cpu)))


def tf32_flag(torch) -> str:
    """What cuBLAS float32 products may use: `fp32_precision` where the
    torch has it ("tf32" or "ieee"), else from `allow_tf32`."""
    fp = getattr(torch.backends.cuda.matmul, "fp32_precision", None)
    if fp is not None:
        return str(fp)
    return "tf32" if torch.backends.cuda.matmul.allow_tf32 else "ieee"


def step_parity(torch, what: str, card_losses, cpu_losses, make_step,
                train_epoch) -> dict:
    """The card's first PARITY_STEPS losses against the CPU port's from
    the same init and batches: max relative difference, gated at
    STEP_RTOL. Beside it, reported and not gated, the same reading in
    the lower precisions the gate is there to catch. The TF32 control:
    `make_step()` builds the net and its Adam on the card from the same
    init (their constructors resolve the device, which turns TF32 off),
    THEN the precision is set to `high`, and the PARITY_STEPS steps run
    through the step function it returns; the phase fails unless
    cuBLAS may still take TF32 at the end of them. The bfloat16 control
    runs one epoch (`train_epoch(losses)`) under autocast. Before the
    controls, the card's steps again from the same init through
    `make_step()` at float32 must give the same losses bit for bit (the
    card's step is deterministic; the CPU reference runs on one thread,
    whose sums are too, ROADMAP F8)."""
    card = [float(x) for x in card_losses[:PARITY_STEPS]]
    rel = max_rel(card_losses, cpu_losses)
    if not rel <= STEP_RTOL:
        fail(f"{what}: the card's step losses "
             f"{card[:4]} ... differ from the "
             f"CPU port's {cpu_losses[:4]} ... by {rel} (tol {STEP_RTOL})")
    step = make_step()
    again = [float(step(s)) for s in range(PARITY_STEPS)]
    if again != card:
        fail(f"{what}: the card's step losses from the same init and "
             f"batches differ between two runs: {card} and {again}")
    step = make_step()
    prior = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        tf32 = [step(s) for s in range(PARITY_STEPS)]
        tf32 = [float(x) for x in tf32]
        flag = tf32_flag(torch)
    finally:
        torch.set_float32_matmul_precision(prior)
    if flag != "tf32":
        fail(f"{what}: the TF32 control ran with fp32 precision {flag!r}")
    bf16 = []
    with torch.autocast("cuda", dtype=torch.bfloat16):
        train_epoch(bf16)
    tf32_rel = max_rel(tf32, cpu_losses)
    return {"max_rel": rel, "tol": STEP_RTOL, "card_losses": card,
            "card_repeat_identical": True, "cpu_threads": 1,
            "tf32_control_flag": flag,
            "tf32_control_max_rel": tf32_rel,
            "tf32_control_within_tol": tf32_rel <= STEP_RTOL,
            "bf16_autocast_control_max_rel": max_rel(bf16, cpu_losses)}


def neural_twotower_op(torch, dev) -> dict:
    """bench_twotower on the card: 190,000 training pairs, emb 64, hidden
    128, out 64, batch 4,096, 10 epochs through `twotower_train`. Gates:
    its first PARITY_STEPS step losses equal the CPU port's from the same
    init and batches (STEP_RTOL); recall@10 on 3,000 held-out pairs at
    least 4x random (10 / 2,000). Its steps timed by `StepClock`, one
    more epoch's call profiled."""
    from predictionio_tpu_torch.ops import twotower as tw
    from predictionio_tpu_torch.ops.adam import Adam
    d = twotower_data()
    ut, it = d["u"][~d["held"]], d["i"][~d["held"]]
    kw = dict(n_users=TT_USERS, n_items=TT_ITEMS, emb_dim=TT_EMB,
              hidden=TT_HIDDEN, out_dim=TT_OUT, batch_size=TT_BATCH,
              seed=0)
    lr, temp = 1e-2, 0.1                     # twotower_train's defaults
    # the CPU port: the first PARITY_STEPS steps from twotower_train's
    # init and batches (seed 0)
    n = len(ut)
    steps = n // TT_BATCH
    order = np.random.RandomState(0).permutation(n)[:steps * TT_BATCH]
    init = tw.random_params(0, TT_USERS, TT_ITEMS, TT_EMB, TT_HIDDEN,
                            TT_OUT)
    # one intra-op thread: the CPU's multi-threaded sums change from run
    # to run, one thread's do not (ROADMAP F8); a copy of the init, which
    # a CPU net's parameters share and Adam updates in place
    import copy
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        net = tw.TwoTowerNet(copy.deepcopy(init), "cpu")
        adam = Adam(list(net.parameters()), lr)
        cpu_losses = []
        for s in range(PARITY_STEPS):
            sel = order[s * TT_BATCH:(s + 1) * TT_BATCH]
            cpu_losses.append(float(tw.train_step(
                net, adam, torch.from_numpy(ut[sel].astype(np.int64)),
                torch.from_numpy(it[sel].astype(np.int64)), temp)))
    finally:
        torch.set_num_threads(prior)
    tw.twotower_train(ut[:2 * TT_BATCH], it[:2 * TT_BATCH], epochs=1,
                      device=dev, **kw)                  # CUDA set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_steps = steps * TT_EPOCHS
    losses, clock = [], StepClock(torch, steps, n_steps)
    t0 = time.perf_counter()
    model = tw.twotower_train(ut, it, epochs=TT_EPOCHS, device=dev,
                              step_losses=losses, on_step=clock, **kw)
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    def tt_step():
        net_c = tw.TwoTowerNet(init, dev)
        adam_c = Adam(list(net_c.parameters()), lr)

        def one(s):
            sel = order[s * TT_BATCH:(s + 1) * TT_BATCH]
            return tw.train_step(
                net_c, adam_c,
                torch.from_numpy(ut[sel].astype(np.int64)).to(dev),
                torch.from_numpy(it[sel].astype(np.int64)).to(dev), temp)
        return one

    parity = step_parity(
        torch, "twotower", losses, cpu_losses, tt_step,
        lambda out: tw.twotower_train(ut, it, epochs=1, device=dev,
                                      step_losses=out, **kw))
    scores = model.user_emb[d["u"][d["sample"]]] @ model.item_emb.T
    top10 = np.argpartition(-scores, 10, axis=1)[:, :10]
    recall = float((top10 == d["i"][d["sample"]][:, None]).any(1).mean())
    random_recall = 10 / TT_ITEMS
    if not recall >= 4 * random_recall:
        fail(f"twotower recall@10 {recall} < 4 x random {random_recall}")
    profiled = profiled_epoch(
        torch, lambda: tw.twotower_train(ut, it, epochs=1, device=dev, **kw),
        steps)
    return {"users": TT_USERS, "items": TT_ITEMS, "train_pairs": n,
            "emb": TT_EMB, "hidden": TT_HIDDEN, "out": TT_OUT,
            "batch": TT_BATCH, "epochs": TT_EPOCHS, "steps": n_steps,
            "train_s": train_s, "examples_per_s": n_steps * TT_BATCH / train_s,
            "steps_timed": clock.report(), "profiled_epoch": profiled,
            "step_parity": parity,
            "first_losses": [float(x) for x in losses[:3]],
            "last_loss": float(losses[-1]), "recall_at_10": recall,
            "random_recall_at_10": random_recall,
            "recall_vs_random": recall / random_recall,
            "peak_device_bytes": peak}


def neural_seqrec_op(torch, dev) -> dict:
    """bench_seqrec on the card: 20,000 users' sequences (90% to train),
    seq_len 32, dim 64, 2 heads, 2 layers, batch 256, 10 epochs through
    `seqrec_train`. Gates: its first PARITY_STEPS step losses equal the
    CPU port's from the same init and batches (STEP_RTOL); next-item
    hit-rate@10 on the held-out sequences at least 0.4 (the planted
    chain's ceiling is about 0.9), beside the measured popularity
    baseline. Its steps timed by `StepClock`, one more epoch's call
    profiled; then `seqrec_encode` ms at batches 1, 64 and 256."""
    from predictionio_tpu_torch.ops import seqrec as sq
    from predictionio_tpu_torch.ops.adam import Adam
    d, st, tt_, init, kw = seqrec_parity_inputs()
    sh, th = d["seqs"][d["held"]], d["targets"][d["held"]]
    lr, temp = 3e-3, 0.07                    # seqrec_train's defaults
    # one intra-op thread: the CPU's multi-threaded sums change from run
    # to run, one thread's do not (ROADMAP F8)
    cpu_losses = seqrec_steps(torch, "cpu", init, st, tt_, threads=1)
    sq.seqrec_train(st[:2 * SR_BATCH], tt_[:2 * SR_BATCH], epochs=1,
                    device=dev, **kw)                    # CUDA set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = len(st) // SR_BATCH
    n_steps = steps * SR_EPOCHS
    losses, clock = [], StepClock(torch, steps, n_steps)
    t0 = time.perf_counter()
    model = sq.seqrec_train(st, tt_, epochs=SR_EPOCHS, device=dev,
                            step_losses=losses, on_step=clock, **kw)
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    def sr_step():
        net_c = sq.SeqRecNet(init, n_items=SR_ITEMS, n_heads=SR_HEADS,
                             device=dev)
        adam_c = Adam(list(net_c.parameters()), lr)

        def one(s):
            rows = slice(s * SR_BATCH, (s + 1) * SR_BATCH)
            return sq.train_step(
                net_c, adam_c,
                torch.from_numpy(st[rows].astype(np.int64)).to(dev),
                torch.from_numpy(tt_[rows].astype(np.int64)).to(dev), temp)
        return one

    parity = step_parity(
        torch, "seqrec", losses, cpu_losses, sr_step,
        lambda out: sq.seqrec_train(st, tt_, epochs=1, device=dev,
                                    step_losses=out, **kw))
    vecs = sq.seqrec_encode(model, sh, device=dev)
    top10 = np.argpartition(-(vecs @ model.item_emb.T), 10, axis=1)[:, :10]
    hr = float((top10 == th[:, None]).any(1).mean())
    pop = np.argsort(-np.bincount(tt_, minlength=SR_ITEMS))[:10]
    pop_hr = float(np.isin(th, pop).mean())
    if not hr >= 0.4:
        fail(f"seqrec hitrate@10 {hr} < 0.4 (popularity {pop_hr})")
    encode = {}
    for b in (1, 64, 256):
        batch = sh[:b]
        sq.seqrec_encode(model, batch, device=dev)
        reps = []
        for _ in range(20):
            t = time.perf_counter()
            sq.seqrec_encode(model, batch, device=dev)
            reps.append(1e3 * (time.perf_counter() - t))
        devnet = model._devp[1]
        seq_dev = torch.from_numpy(batch.astype(np.int64)).to(dev)
        with torch.inference_mode():
            ev_ms = time_ms(torch, lambda: devnet(seq_dev), 20)
        encode[str(b)] = {"host_ms_median": float(np.median(reps)),
                          "device_ms": ev_ms}
    profiled = profiled_epoch(
        torch, lambda: sq.seqrec_train(st, tt_, epochs=1, device=dev, **kw),
        steps)
    return {"users": SR_USERS, "items": SR_ITEMS,
            "train_sequences": len(st), "held_out": len(sh),
            "seq_len": SR_SEQ, "dim": SR_DIM, "heads": SR_HEADS,
            "layers": SR_LAYERS, "batch": SR_BATCH, "epochs": SR_EPOCHS,
            "steps": n_steps, "train_s": train_s,
            "examples_per_s": n_steps * SR_BATCH / train_s,
            "steps_timed": clock.report(), "profiled_epoch": profiled,
            "step_parity": parity,
            "first_losses": [float(x) for x in losses[:3]],
            "last_loss": float(losses[-1]), "hitrate_at_10": hr,
            "popularity_hitrate_at_10": pop_hr,
            "hitrate_vs_popularity": hr / max(pop_hr, 1e-9),
            "encode": encode, "peak_device_bytes": peak}


def seqrec_parity_inputs():
    """Phase neural's seqrec step-parity inputs: the training sequences
    and targets, the init (random_params, seed 0) and the trainer's
    keyword arguments."""
    from predictionio_tpu_torch.ops import seqrec as sq
    d = seqrec_data(SR_USERS)
    st, tt_ = d["seqs"][~d["held"]], d["targets"][~d["held"]]
    kw = dict(n_items=SR_ITEMS, seq_len=SR_SEQ, dim=SR_DIM,
              n_heads=SR_HEADS, n_layers=SR_LAYERS, batch_size=SR_BATCH,
              seed=0)
    return d, st, tt_, sq.random_params(0, SR_ITEMS, SR_SEQ, SR_DIM,
                                        SR_LAYERS), kw


def seqrec_steps(torch, dev, init, st, tt_, threads: int = 0) -> list:
    """The port's first PARITY_STEPS seqrec steps (`train_step`, lr and
    temperature as `seqrec_train`'s defaults) on `dev` from a copy of
    `init` (the net's parameters share a CPU init's memory, and Adam
    updates them in place); on the CPU at `threads` intra-op threads
    when given. Returns the losses as floats."""
    import copy
    from predictionio_tpu_torch.ops import seqrec as sq
    from predictionio_tpu_torch.ops.adam import Adam
    prior = torch.get_num_threads()
    if threads:
        torch.set_num_threads(threads)
    try:
        net = sq.SeqRecNet(copy.deepcopy(init), n_items=SR_ITEMS,
                           n_heads=SR_HEADS, device=dev)
        adam = Adam(list(net.parameters()), 3e-3)
        out = []
        for s in range(PARITY_STEPS):
            rows = slice(s * SR_BATCH, (s + 1) * SR_BATCH)
            out.append(sq.train_step(
                net, adam, torch.from_numpy(st[rows].astype(np.int64)).to(dev),
                torch.from_numpy(tt_[rows].astype(np.int64)).to(dev), 0.07))
        return [float(x) for x in out]
    finally:
        torch.set_num_threads(prior)


STEP_LOAD = r"""
import sys, time
if sys.argv[1] == "card":
    import torch
    a = torch.randn(4096, 4096, device="cuda")
    end = time.time() + float(sys.argv[2])
    while time.time() < end:
        for _ in range(20):
            a = torch.tanh(a @ a)
        torch.cuda.synchronize()
else:
    end = time.time() + float(sys.argv[2])
    while time.time() < end:
        pass
"""


def phase_steps(torch, dev, card: str) -> dict:
    """`--only steps`: what moves seqrec's step parity from run to run.
    The card's PARITY_STEPS losses from the same init three times, and
    `seqrec_train`'s first ones; the CPU port's at 1, 2 and 4 intra-op
    threads and at the process's default, twice each; then the card's
    and the CPU's once more beside a loaded card (another process's
    matrix products) and a loaded host (a busy process per CPU). Gates
    nothing; prints every loss and which runs agree bit for bit."""
    from predictionio_tpu_torch.ops import seqrec as sq
    t_phase = time.perf_counter()
    _, st, tt_, init, kw = seqrec_parity_inputs()
    card_runs = [seqrec_steps(torch, dev, init, st, tt_) for _ in range(3)]
    trained = []
    sq.seqrec_train(st[:PARITY_STEPS * SR_BATCH], tt_[:PARITY_STEPS
                                                     * SR_BATCH],
                    epochs=1, device=dev, step_losses=trained, **kw)
    trained = [float(x) for x in trained]
    default = torch.get_num_threads()
    counts = sorted({1, 2, 4, default})
    cpu = {n: [seqrec_steps(torch, "cpu", init, st, tt_, n)
               for _ in range(2)] for n in counts}
    loads = [subprocess.Popen([sys.executable, "-c", STEP_LOAD, "card",
                               "120"])]
    loads += [subprocess.Popen([sys.executable, "-c", STEP_LOAD, "host",
                                "120"]) for _ in range(os.cpu_count() or 1)]
    for proc in loads:
        _BACKGROUND.add(proc)
    try:
        time.sleep(10)                  # the card's load under way
        card_loaded = seqrec_steps(torch, dev, init, st, tt_)
        cpu_loaded = {n: seqrec_steps(torch, "cpu", init, st, tt_, n)
                      for n in (1, default)}
    finally:
        for proc in loads:
            proc.kill()
            proc.wait()
            _BACKGROUND.discard(proc)
    ref = card_runs[0]
    out = {"phase": "steps", "card": card, "default_threads": default,
           "card_losses": ref,
           "card_runs_identical": all(r == ref for r in card_runs),
           "seqrec_train_identical": trained[:PARITY_STEPS] == ref,
           "card_loaded_identical": card_loaded == ref,
           "cpu": {str(n): {"losses": runs[0],
                            "repeat_identical": runs[0] == runs[1],
                            "max_rel_card": max_rel(ref, runs[0])}
                   for n, runs in cpu.items()},
           "cpu_loaded_identical": {str(n): v == cpu[n][0]
                                    for n, v in cpu_loaded.items()},
           "cpu_loaded_max_rel_card": {str(n): max_rel(ref, v)
                                       for n, v in cpu_loaded.items()},
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    return out


def neural_ingest(events, app_id: int, users, items, t_ms) -> dict:
    """`view` events (user, item, time) into the port's PEVLOG DAO in
    process (`insert_batch` of 50,000)."""
    from predictionio_tpu_torch.data.event import DataMap, Event, from_millis
    t0 = time.perf_counter()
    ul, il, tl = users.tolist(), items.tolist(), t_ms.tolist()
    n = len(ul)
    for lo in range(0, n, 50_000):
        events.insert_batch([Event(
            event="view", entity_type="user", entity_id=f"u{ul[j]}",
            target_entity_type="item", target_entity_id=f"i{il[j]}",
            properties=DataMap({}), event_time=from_millis(tl[j]))
            for j in range(lo, min(lo + 50_000, n))], app_id)
    return {"events": n, "seconds": time.perf_counter() - t0,
            "events_per_s": n / (time.perf_counter() - t0)}


def neural_queries(rng, n_users: int, n_items: int, n: int) -> list:
    """`n` queries of known users, num 1-10, every third with a blackList
    of 3 items, every 16th with a whiteList of 50; two unknown users."""
    qs = []
    for j in range(n - 2):
        q = {"user": f"u{int(rng.integers(n_users))}",
             "num": int(rng.integers(1, 11))}
        if j % 3 == 0:
            q["blackList"] = [f"i{int(x)}" for x in
                              rng.integers(0, n_items, 3)]
        if j % 16 == 5:
            q["whiteList"] = [f"i{int(x)}" for x in
                              rng.choice(n_items, 50, replace=False)]
        qs.append(q)
    return qs + [{"user": "ghost-1", "num": 5}, {"user": "ghost-2", "num": 3}]


def seqrec_histories(model, u, i, t):
    """Seqrec's serve-time history for every user from the events the
    smoke wrote, in numpy, independent of the store and the template:
    per user the 4 x seq_len newest events, those whose item the model
    knows, oldest first, the last seq_len. `u` and `i` are the numbers
    of the ids `u<n>` and `i<n>` (-1: an item id of another form), `t`
    the event times in ms. Returns user id -> [item index]."""
    S = model.net.seq_len
    ix_of = np.array([model.items.get(f"i{n}", -1)
                      for n in range(int(i.max()) + 1)])
    known = np.where(i >= 0, ix_of[np.maximum(i, 0)], -1)
    order = np.lexsort((-t, u))              # by user, newest first
    us, ks = u[order], known[order]

    def history(user: str) -> list:
        if not (user[:1] == "u" and user[1:].isdigit()):
            return []
        lo, hi = np.searchsorted(us, [int(user[1:]), int(user[1:]) + 1])
        newest = ks[lo:min(hi, lo + 4 * S)]
        return [int(x) for x in newest[::-1] if x >= 0][-S:]

    return history


def neural_expected(model, queries, history=None) -> list:
    """Per query, on the CPU from the served model's vectors: (float64
    scores of every item, the `score_and_rank` answer), or (None, ())
    for a user without a vector (unknown, or no history). Two-tower
    reads the user's tower row; seqrec (`history` given, see
    `seqrec_histories`) encodes the histories in one batch."""
    from predictionio_tpu_torch.models.common import score_and_rank
    from predictionio_tpu_torch.models.recommendation import Query
    from predictionio_tpu_torch.ops.seqrec import seqrec_encode
    emb = (model.net.item_emb).astype(np.float64)
    qs = [Query(**q) for q in queries]
    if history is None:
        vecs = [None if (ix := model.users.get(q.user)) is None
                else model.net.user_emb[ix] for q in qs]
    else:
        S = model.net.seq_len
        hists = [history(q.user) for q in qs]
        seqs = np.full((len(qs), S), model.net.n_items, np.int32)
        for row, hist in enumerate(hists):
            if hist:
                seqs[row, S - len(hist):] = hist
        enc = seqrec_encode(model.net, seqs, device="cpu")
        vecs = [enc[row] if hist else None
                for row, hist in enumerate(hists)]
    out = []
    for n, (query, vec) in enumerate(zip(qs, vecs)):
        if vec is None:
            out.append((None, ()))
            continue
        (_, res), = score_and_rank(vec[None, :], model.net.item_emb,
                                   model.items, [(n, query)], device="cpu")
        out.append((emb @ vec.astype(np.float64), res.itemScores))
    return out


def check_neural(what: str, answers, expected, items) -> float:
    """Served answers against `neural_expected`: the same length, scores
    within NEURAL_TOL of the CPU's at each rank, and where an id differs,
    the served item's float64 score within NEURAL_TOL of the CPU's at
    that rank (a near-tie); no answer for a user without a vector.
    Returns max |score diff|."""
    err = 0.0
    for n, (body, (full, want)) in enumerate(zip(answers, expected)):
        got = body["itemScores"]
        if full is None:
            if got:
                fail(f"{what} query {n}: an answer for a user without "
                     f"history or vector: {got[:2]}")
            continue
        if len(got) != len(want):
            fail(f"{what} query {n}: {len(got)} items, the CPU {len(want)}")
        for j, (g, w) in enumerate(zip(got, want)):
            e = abs(g["score"] - w.score)
            err = max(err, e)
            gi = items.get(g["item"])
            if e > NEURAL_TOL or gi is None or (
                    g["item"] != w.item
                    and abs(full[gi] - w.score) > NEURAL_TOL):
                fail(f"{what} query {n} rank {j}: {g} vs the CPU's {w}")
    return err


def neural_template(torch, name: str, tmp: Path, config: dict, rng,
                    data: dict, beside=None) -> dict:
    """One neural template through the command line over SQLITE + PEVLOG:
    its app (`cli.ops.app_new` in process), the events in process while
    `cli build` runs (and `beside()`, if given), `train`, `deploy
    --refresh-interval 2`; NEURAL_REQUESTS queries from NEURAL_CLIENTS
    threads, each answer checked against `score_and_rank` on the CPU
    from the served model's vectors, seqrec's histories taken from the
    events written (`seqrec_histories`, `check_neural`); a drip of 192
    known-entity events folded by one warm-start epoch (a `folded` tick,
    the answers moved); an event on a new item rebuilt in full under
    client load (NEURAL_CLIENTS threads, NEURAL_PACE_S apart) with no
    failed request; `cli batchpredict` of NEURAL_BP queries, each
    checked likewise. Gates also: no K1 or K2 launch in the deploy
    process."""
    from predictionio_tpu_torch.cli.ops import app_new
    from predictionio_tpu_torch.data.event import DataMap, Event, from_millis
    from predictionio_tpu_torch.data.storage import (EngineInstanceStatus,
                                                     StorageRegistry)
    work = tmp / name
    work.mkdir()
    cli = cli_runner(work, config, PIO_INGEST_WORKERS="4")
    if name == "twotower":
        algo_params = {"emb_dim": TT_EMB, "hidden": TT_HIDDEN,
                       "out_dim": TT_OUT, "batch_size": TT_BATCH,
                       "epochs": TT_EPOCHS, "seed": 0}
    else:
        algo_params = {"app_name": name, "seq_len": SR_SEQ, "dim": SR_DIM,
                       "n_heads": SR_HEADS, "n_layers": SR_LAYERS,
                       "batch_size": SR_BATCH, "epochs": SR_EPOCHS,
                       "seed": 0}
    (work / "engine.json").write_text(json.dumps({
        "id": name, "engineFactory": name,
        "datasource": {"params": {"app_name": name}},
        "algorithms": [{"name": name, "params": algo_params}]}))
    registry = StorageRegistry(config)
    app = app_new(registry, name)
    events = registry.get_events()
    # `cli build` reads no event: it runs while the events go in
    with ThreadPoolExecutor(2) as pool:
        build = pool.submit(cli, "build")
        side = pool.submit(beside) if beside is not None else None
        ingest = neural_ingest(events, app["id"], data["u"], data["i"],
                               data["t_ms"])
        _, build_s = build.result()
        beside_out = side.result() if side is not None else None
    written = [(data["u"], data["i"], data["t_ms"])]
    report, train_wall = cli("train")
    if report["status"] != EngineInstanceStatus.COMPLETED:
        fail(f"{name}: the instance is {report['status']}")
    iid = report["engineInstanceId"]
    model, _ = read_model(config, iid, "cpu")
    n_users, n_items = len(model.users), len(model.items)
    queries = neural_queries(rng, data["n_users"], n_items, NEURAL_REQUESTS)
    proc, port, deploy_s = start_deploy(
        work, cli, iid, "--engine-instance-id", iid, "--refresh-interval",
        str(STREAM_INTERVAL_S))
    try:
        st0 = wait_status(port, proc, f"{name}: the refresher's baseline",
                          lambda s: s["refresh"]["ticks"].get("baseline"),
                          120)
        t0 = time.perf_counter()
        answers = serve_http(port, queries, NEURAL_CLIENTS)
        serve_wall = time.perf_counter() - t0
        st1 = http_status(port)
        expected = neural_expected(model, queries, None if name == "twotower"
                                   else seqrec_histories(model, *map(
                                       np.concatenate, zip(*written))))
        err = check_neural(f"{name} deploy", [b for b, _ in answers],
                           expected, model.items)
        # the drip: 64 known users x 3 known items, stamped now
        now_ms = int(time.time() * 1e3)
        drip_u = rng.choice(n_users, 64, replace=False)
        drip = [Event(event="view", entity_type="user",
                      entity_id=model.users.inverse(int(u)),
                      target_entity_type="item",
                      target_entity_id=model.items.inverse(
                          int(rng.integers(n_items))),
                      properties=DataMap({}),
                      event_time=from_millis(now_ms - 1_000 + 5 * j))
                for j, u in enumerate(np.repeat(drip_u, 3))]
        written.append(tuple(np.array(c, np.int64) for c in zip(*(
            (int(e.entity_id[1:]), int(e.target_entity_id[1:]),
             now_ms - 1_000 + 5 * j) for j, e in enumerate(drip)))))
        t_drip = time.perf_counter()
        events.insert_batch(drip, app["id"])
        st2 = wait_status(port, proc, f"{name}: the fold",
                          lambda s: s["refresh"]["ticks"].get("folded"), 300)
        fold_seen_s = time.perf_counter() - t_drip
        folded = serve_http(port, queries, NEURAL_CLIENTS)
        moved = sum(1 for (a, _), (b, _) in zip(answers, folded)
                    if a != b)
        if not moved or any(b["itemScores"] == [] and e[0] is not None
                            for (b, _), e in zip(folded, expected)):
            fail(f"{name}: after the fold {moved} answers moved")
        # an event on a new item: the next tick rebuilds in full
        with Hammer(port, queries, NEURAL_PACE_S) as load:
            new_ms = int(time.time() * 1e3)
            events.insert(Event(
                event="view", entity_type="user", entity_id="u0",
                target_entity_type="item", target_entity_id="new-item",
                properties=DataMap({}), event_time=from_millis(new_ms)),
                app["id"])
            written.append((np.array([0]), np.array([-1]),
                            np.array([new_ms])))
            t_new = time.perf_counter()
            st3 = wait_status(port, proc, f"{name}: the full rebuild",
                              lambda s: s["refresh"]["ticks"].get(
                                  "full_rebuild"), 300)
            rebuild_seen_s = time.perf_counter() - t_new
        after = serve_http(port, queries[:16], NEURAL_CLIENTS)
        st4 = http_status(port)
    finally:
        stop_deploy(proc)
    if load.failures:
        fail(f"{name}: {len(load.failures)} requests failed during the "
             f"rebuild: {load.failures[:3]}")
    ticks = st4["refresh"]["ticks"]
    if any(ticks.get(k) for k in ("rolled_back", "failed")) or \
            ticks.get("folded", 0) < 1:
        fail(f"{name}: refresher ticks {ticks}")
    if any(not b["itemScores"] for (b, _), e in zip(after, expected)
           if e[0] is not None):
        fail(f"{name}: empty answers after the rebuild")
    launches = st4["kernel_launches"]
    if launches["fused_topk"] or launches["shard_local_candidates"]:
        fail(f"{name}: the deploy launched K1 / K2: {launches}")
    bp_q = neural_queries(rng, data["n_users"], n_items, NEURAL_BP)
    lines = [json.dumps(q) for q in bp_q]
    (work / "bp_in.jsonl").write_text("\n".join(lines) + "\n")
    bp, bp_wall = cli("batchpredict", "--input", "bp_in.jsonl",
                      "--output", "bp_out.jsonl")
    rows = [json.loads(x) for x in
            (work / "bp_out.jsonl").read_text().splitlines()]
    if bp["predictions"] != NEURAL_BP or bp["engineInstanceId"] != iid or \
            [r["query"] for r in rows] != bp_q:
        fail(f"{name}: batchpredict printed {bp}; its lines are not the "
             "queries in order")
    bp_err = check_neural(
        f"{name} batchpredict", [r["prediction"] for r in rows],
        neural_expected(model, bp_q, None if name == "twotower" else
                        seqrec_histories(model, *map(np.concatenate,
                                                     zip(*written)))),
        model.items)
    registry.close()
    tm = report["phaseTimings"]
    sp = st1["serve_paths"][0]
    return {"engine_instance": iid, "users": n_users, "items": n_items,
            "ingest": ingest, "build_wall_s": build_s,
            "train": {"command_wall_s": train_wall,
                      "read_s": tm.get("read_s"),
                      "train_algo0_s": tm.get("train_algo0_s")},
            "deploy": {"command_to_serving_s": deploy_s,
                       **st0["deploy_timings"]},
            "serve": {"requests": len(queries), "clients": NEURAL_CLIENTS,
                      "answers_checked": len(queries), "max_abs_err": err,
                      "wall_s": serve_wall, "qps": len(queries) / serve_wall,
                      "latency_ms": latency_ms(answers),
                      "batch_sizes": st1["batch_sizes"],
                      "serve_paths": sp,
                      "store_read_ms": (1e3 * sp["store_read_s"]
                                        / sp["store_reads"]
                                        if sp.get("store_reads") else None),
                      "devices": st1["devices"]},
            "fold": {"events": len(drip), "seen_after_s": fold_seen_s,
                     "tick_s": st2["refresh"]["last_ticks"]["folded"],
                     "freshness_s": st2["refresh"]["freshness_s"],
                     "answers_moved": moved},
            "rebuild": {"seen_after_s": rebuild_seen_s,
                        "tick_s": st3["refresh"]["last_ticks"][
                            "full_rebuild"],
                        "load": load.summary(), "ticks": ticks},
            "batchpredict": {"queries": NEURAL_BP, "command_wall_s": bp_wall,
                             "queries_per_s": NEURAL_BP / bp_wall,
                             "answers_checked": len(rows),
                             "max_abs_err": bp_err},
            "deploy_kernel_launches": launches,
            **({} if beside is None else {"beside": beside_out})}


SCAFFOLD_EVENTS = 5_000


def neural_scaffold_app(config: dict, data: dict) -> None:
    """The scaffolds' app `myapp` (`cli.ops.app_new` in process) with the
    two-tower generator's first SCAFFOLD_EVENTS events."""
    from predictionio_tpu_torch.cli.ops import app_new
    from predictionio_tpu_torch.data.storage import StorageRegistry
    registry = StorageRegistry(config)
    app = app_new(registry, "myapp")
    n = SCAFFOLD_EVENTS
    neural_ingest(registry.get_events(), app["id"], data["u"][:n],
                  data["i"][:n], NEURAL_T0_MS + np.arange(n))
    registry.close()


def neural_scaffolds(tmp: Path, config: dict) -> dict:
    """`cli template new --base twotower` and `--base seqrec`, then `cli
    build` and `train` in each scaffold (the scaffold's defaults; the two
    side by side) over `neural_scaffold_app`'s `myapp`. Gate: both
    COMPLETED."""
    from predictionio_tpu_torch.data.storage import EngineInstanceStatus
    cli = cli_runner(tmp, config)

    def scaffold(base):
        made, _ = cli("template", "new", f"scaffold_{base}", "--base", base)
        scli = cli_runner(tmp / f"scaffold_{base}", config)
        _, build_s = scli("build")
        report, train_s = scli("train")
        if report["status"] != EngineInstanceStatus.COMPLETED:
            fail(f"template new --base {base}: {report['status']}")
        return {"build_wall_s": build_s, "train_wall_s": train_s,
                "train_algo0_s": report["phaseTimings"].get("train_algo0_s"),
                "message": made["message"].split(" at ")[0]}

    # the two scaffolds side by side (each is process start-up around
    # seconds of work)
    with ThreadPoolExecutor(2) as pool:
        done = dict(zip(("twotower", "seqrec"),
                        pool.map(scaffold, ("twotower", "seqrec"))))
    return {"events": SCAFFOLD_EVENTS, **done}


def phase_neural(torch, ft, dev, seed: int, card: str) -> dict:
    """The two-tower and sequential recommenders on the card: attention
    (`neural_attention`), the two trainers at bench.py's data and widths
    (`neural_twotower_op`, `neural_seqrec_op`), both templates through
    the command line (`neural_template`) and the `template new` scaffolds
    (`neural_scaffolds`). No K1 or K2 launch anywhere in the phase."""
    t_phase = time.perf_counter()
    before = (ft.LAUNCHES, ft.SHARD_LAUNCHES)
    out = {"phase": "neural", "card": card, "part_seconds": {}}

    def part(key, fn):
        t = time.perf_counter()
        out[key] = fn()
        out["part_seconds"][key] = time.perf_counter() - t
        return out[key]

    for key, fn in (("attention", lambda: neural_attention(torch, dev, seed)),
                    ("twotower_op", lambda: neural_twotower_op(torch, dev)),
                    ("seqrec_op", lambda: neural_seqrec_op(torch, dev))):
        emit({"phase": f"neural_{key}", "card": card, **part(key, fn)})
    rng = np.random.default_rng(seed + 10)
    tt = twotower_data()
    sr = seqrec_data(SR_USERS)
    day = sr["u"] % SR_DAYS
    templates_data = {
        "twotower": {"u": tt["u"], "i": tt["i"], "n_users": TT_USERS,
                     "t_ms": NEURAL_T0_MS + np.arange(TT_EVENTS)},
        "seqrec": {"u": sr["u"], "i": sr["i"], "n_users": SR_USERS,
                   "t_ms": (NEURAL_T0_MS + day * DAY_MS
                            + sr["offs"] * 60_000)}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_neural_") as tmp:
        tmp = Path(tmp)
        config = {"PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
                  "PIO_STORAGE_SOURCES_DB_PATH": str(tmp / "pio.db"),
                  "PIO_STORAGE_SOURCES_PEV_TYPE": "PEVLOG",
                  "PIO_STORAGE_SOURCES_PEV_PATH": str(tmp / "pevlog"),
                  "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
                  "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "PEV",
                  "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB"}
        # made first, in process: the store's files exist before any
        # two processes open them at once
        neural_scaffold_app(config, tt)
        emit({"phase": "neural_template_twotower", "card": card,
              **part("template_twotower", lambda: neural_template(
                  torch, "twotower", tmp, config, rng,
                  templates_data["twotower"]))})
        # the scaffolds build and train while seqrec's events go in
        emit({"phase": "neural_template_seqrec", "card": card,
              **part("template_seqrec", lambda: neural_template(
                  torch, "seqrec", tmp, config, rng,
                  templates_data["seqrec"],
                  beside=lambda: neural_scaffolds(tmp, config)))})
        out["scaffolds"] = out["template_seqrec"].pop("beside")
    out["seqrec_store"] = {"users": SR_USERS, "events": int(len(sr["u"])),
                           "days": SR_DAYS}
    k1, k2 = ft.LAUNCHES - before[0], ft.SHARD_LAUNCHES - before[1]
    if k1 or k2:
        fail(f"K1 launched {k1}, K2 {k2} times during phase neural")
    out["k1_launches"], out["k2_launches"] = k1, k2
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "neural", "card": card, "k1_launches": k1,
          "k2_launches": k2,
          "tf32_control": {k: {f: out[f"{k}_op"]["step_parity"][f]
                               for f in ("tf32_control_flag",
                                         "tf32_control_max_rel",
                                         "tf32_control_within_tol")}
                           for k in ("twotower", "seqrec")},
          "seconds": out["seconds"],
          "part_seconds": out["part_seconds"],
          "seqrec_store": out["seqrec_store"],
          "scaffolds": out["scaffolds"]})
    return out


def obs_only(torch, ft, dev, rng, model) -> dict:
    """`--only obs`: phase wire's selector pass of its whole mix on
    phase 4's model (the untraced reference), then phase obs (a) on
    that server."""
    reqs = wire_requests(torch, ft, dev, rng, model, WIRE_PLAIN,
                         WIRE_BANNED, WIRE_BIN)
    obs_reqs = wire_requests(torch, ft, dev, rng, model, OBS_PLAIN,
                             OBS_BANNED, OBS_BIN)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as tmp:
        run = wire_run(torch, ft, dev, model, reqs, Path(tmp), "selector",
                       obs_reqs=obs_reqs)
    if sorted({r[0] for r in run["res"]}) != [200]:
        fail("obs: the untraced selector pass failed requests")
    check_wire_answers(torch, ft, dev, model, reqs, run["res"], "selector")
    return {"a": run["obs"], "quality": run["quality"],
            "untraced_selector": lat_summary(run["res"],
                                             range(len(run["res"])))}


def phase_quality(card: str, a: dict, bc: dict, d: Optional[dict]) -> dict:
    """Phase quality's line, from the parts its hosts ran and gated: (a)
    phase wire's selector server (`quality_pass`), (b) and (c) inside
    phase fleet (`canary_gates`, `canary_veto`), (d) inside phase
    quickstart (`quality_conversions`; None under `--only quality`).
    Its launches: (a)'s two passes and (c)'s server; (b)'s canary
    replays are fleet (b)'s launches."""
    out = {"phase": "quality", "card": card, "a": a, "b": bc["b"],
           "c": bc["c"], "d": d,
           "launches": a["launches"] + bc["c"]["launches"]}
    emit(out)
    return out


def phase_obs(card: str, parts: dict) -> dict:
    """Phase obs's line: (a) the traced pass beside the untraced
    selector pass (qps, p50, p99, the segments' means), and, in the
    whole run, (b) the fleet's stitching, (c) the refresher's spans with
    ingestd off the card, (d) the profiled train; each part's seconds
    (its own work inside the phase that ran it) and their sum."""
    a = parts["a"]
    parts = {**parts, "a": {k: v for k, v in a.items()
                            if k != "segment_mean_ms"}}
    parts_s = {"a": a["seconds"]}
    for k in ("b", "c", "d"):
        if k in parts:
            parts_s[k] = parts[k].get("seconds", parts[k].get("parse_s"))
    out = {"phase": "obs", "card": card,
           "traced": a["all"], "untraced": parts["untraced_selector"],
           "traced_qps_over_untraced": a["all"]["qps"]
           / parts["untraced_selector"]["qps"],
           "segment_mean_ms": a["segment_mean_ms"], **parts,
           "parts_s": parts_s, "seconds": sum(parts_s.values())}
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
                                       "templates", "classification",
                                       "neural", "wire", "fleet",
                                       "storage", "ingest", "obs",
                                       "quality", "pressure", "elastic",
                                       "chaos", "steps"),
                    help="run only the build and these phases (serve_sharded"
                         " for a machine with several cards; train for "
                         "train_parity, train and serve_trained; lifecycle "
                         "for parity and lifecycle; streaming for parity "
                         "and streaming; quickstart for parity and "
                         "quickstart; templates for parity and "
                         "templates; classification for parity and "
                         "classification; neural for phase neural; wire "
                         "for parity and wire; fleet for parity, one "
                         "direct selector pass and fleet; storage for "
                         "parity and storage; ingest for parity, the "
                         "PEVLOG project and ingest; obs for parity and "
                         "phase obs (a) on phase serve's model; quality "
                         "for parity, phase wire's selector pass with "
                         "quality (a), phase fleet with (b) and (c); "
                         "pressure for parity, the PEVLOG project and "
                         "phase pressure; elastic for parity and phase "
                         "elastic; chaos for parity and phase chaos; "
                         "steps for the seqrec step "
                         "diagnostic), no kernels line")
    args = ap.parse_args()
    t_script = time.perf_counter()
    # a SIGTERM (a phase process stopped by its parent) exits through
    # the `finally` blocks and `_stop_background`, which stop the
    # servers and commands started
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    # one structured line per HTTP request is too many for this run's
    # output; the deploy subprocesses inherit the level
    os.environ.setdefault("PIO_OBS_LOG_LEVEL", "WARNING")

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

    def pevlog_phases(streaming: bool, quickstart: bool, ingest: bool,
                      beside=None, pressure: bool = False):
        """Phases streaming, quickstart, ingest and pressure over one
        PEVLOG project: one import and one train for all. `beside`, phase
        lifecycle, runs while the PEVLOG import does (their imports
        overlap, one process each). Phase ingest's scans and train run
        on the project's thread after its train (beside phase
        lifecycle), its deploy, drip and kill after phase quickstart;
        phase pressure last."""
        with tempfile.TemporaryDirectory(prefix="chip_smoke_pevlog_") as tmp:
            started = pevlog_import(
                Path(tmp), args.seed,
                (lambda st, tr: ingest_scan_train(torch, dev, st, tr))
                if ingest else None)
            ran = beside() if beside is not None else None
            project = pevlog_project(started, dev)
            import_eps = (project["n_train"]
                          / project["imported"]["seconds"])
            sqlite_eps = ran["import"]["events_per_s"] if ran else None
            st = phase_streaming(torch, ft, dev, rng, project,
                                 args.streaming_requests,
                                 sqlite_eps) if streaming else None
            qs = phase_quickstart(torch, ft, dev, rng, project,
                                  args.quickstart_requests,
                                  import_eps) if quickstart else None
            ing = ingest_serve_fold(torch, ft, dev, rng, project) \
                if ingest else None
            pr = phase_pressure(torch, ft, dev, rng, project, card) \
                if pressure else None
        return ran, st, qs, ing, pr

    # a phase process of a whole run: that run held the kernel to its
    # plain version already
    in_phase_process = os.environ.get("CHIP_SMOKE_PHASE_PROCESS") == "1"
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
            if not in_phase_process:
                phase_parity(torch, ft, dev, rng)
            phase_templates(torch, ft, dev, rng, args.seed,
                            args.templates_requests)
        elif args.only == "classification":
            if not in_phase_process:
                phase_parity(torch, ft, dev, rng)
            phase_classification(torch, ft, dev, args.seed, card)
        elif args.only == "neural":
            phase_neural(torch, ft, dev, args.seed, card)
        elif args.only == "steps":
            phase_steps(torch, dev, card)
        elif args.only == "wire":
            phase_parity(torch, ft, dev, rng)
            model, _ = make_model(torch, rng)
            phase_wire(torch, ft, dev, rng, model, card)
        elif args.only == "fleet":
            phase_parity(torch, ft, dev, rng)
            model, _ = make_model(torch, rng)
            phase_fleet(torch, ft, dev, rng, model, card,
                        wire_reference(torch, ft, dev, rng, model))
        elif args.only == "storage":
            phase_parity(torch, ft, dev, rng)
            model, _ = make_model(torch, rng)
            phase_storage(torch, ft, dev, rng, model, card, args.seed)
        elif args.only == "obs":
            phase_parity(torch, ft, dev, rng)
            model, _ = make_model(torch, rng)
            phase_obs(card, obs_only(torch, ft, dev, rng, model))
        elif args.only == "quality":
            phase_parity(torch, ft, dev, rng)
            model, _ = make_model(torch, rng)
            a = obs_only(torch, ft, dev, rng, model)
            fleet = phase_fleet(torch, ft, dev, rng, model, card,
                                a["untraced_selector"])
            phase_quality(card, a["quality"], fleet["quality_bc"], None)
        elif args.only == "pressure":
            phase_parity(torch, ft, dev, rng)
            pevlog_phases(False, False, False, pressure=True)
        elif args.only == "elastic":
            if not in_phase_process:
                phase_parity(torch, ft, dev, rng)
            model, _ = make_model(torch, rng)
            rates = os.environ.get("CHIP_SMOKE_ELASTIC_CALIBRATE", "")
            phase_elastic(torch, ft, dev, rng, model, card, calibrate=[
                float(r) for r in rates.split(",") if r] or None)
        elif args.only == "chaos":
            if not in_phase_process:
                phase_parity(torch, ft, dev, rng)
            model, _ = make_model(torch, rng)
            phase_chaos(torch, ft, dev, rng, model, card)
        else:
            phase_parity(torch, ft, dev, rng)
            pevlog_phases(args.only == "streaming",
                          args.only == "quickstart", args.only == "ingest")
        emit({"script_s": time.perf_counter() - t_script})
        print(smi_line(), flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    err = phase_parity(torch, ft, dev, rng)
    model, setup_s = make_model(torch, rng)
    serve = phase_serve(torch, ft, dev, rng, model, setup_s, args.requests)
    # phase wire's qps and the timing phases have the card and the host
    # to themselves
    wire = phase_wire(torch, ft, dev, rng, model, card)
    timing = phase_timing(torch, ft, dev, rng, card)
    timing_ec = phase_timing_ecommerce(torch, ft, dev, rng, card)
    timing_sh = phase_timing_sharded(torch, ft, dev, rng, model, card)
    fleet = phase_fleet(torch, ft, dev, rng, model, card,
                        wire["wires"]["selector"]["all"])
    # the phases that need nothing of the ML-1M chain run beside it, each
    # in a process of its own (F7): the ML-25M train, the templates,
    # classification and the neural recommenders
    side = {name: start_phase_process(name, args.seed)
            for name in ("train", "templates", "classification", "neural")}
    # phase chaos in a process of its own once those four have ended,
    # beside the rest of the chain (its drills' 0.1-s probes and 0.5-s
    # lease want a host that the four no longer load)
    chaos_proc = []

    def start_chaos():
        for proc in side.values():
            proc.wait()
        chaos_proc.append(start_phase_process("chaos", args.seed))

    chaos_starter = threading.Thread(target=start_chaos, daemon=True)
    chaos_starter.start()
    storage = phase_storage(torch, ft, dev, rng, model, card, args.seed)
    err_sh = phase_parity_sharded(torch, ft, dev, rng, model)
    serve_sh = phase_serve_sharded(torch, ft, dev, rng, model,
                                   args.sharded_requests)
    tiered = phase_serve_tiered(torch, ft, dev, rng, model,
                                args.tiered_queries)
    del model
    lifecycle, streaming, quickstart, ingest, pressure = pevlog_phases(
        True, True, True,
        lambda: phase_lifecycle(torch, ft, dev, rng, args.seed,
                                args.lifecycle_requests), pressure=True)
    served = finish_phase_process(side["train"],
                                  also=("serve_trained",))["serve_trained"]
    templates = finish_phase_process(side["templates"])
    classification = finish_phase_process(side["classification"])
    neural = finish_phase_process(side["neural"])
    chaos_starter.join()
    chaos = finish_phase_process(chaos_proc[0])
    # the elastic fleet last, on a host of its own: beside the chain or
    # three busy loops the member p99 of its base rate read as high as
    # its flash (PERF.md), and its flash beside the templates pushed the
    # e-commerce template's first request past its 30-s deadline
    elastic = finish_phase_process(start_phase_process("elastic", args.seed))
    quality = phase_quality(card, wire["quality"], fleet["quality_bc"],
                            quickstart["quality_d"])
    phase_obs(card, {
        "a": wire["obs"],
        "untraced_selector": wire["wires"]["selector"]["all"],
        "b": fleet["supervised"]["obs_b"], "c": ingest["c"]["obs_c"],
        "d": lifecycle["obs"]})

    main_row, shard_row = timing[64], timing_sh[64]
    emit({"script_s": time.perf_counter() - t_script})
    emit({"kernels": [{
        "name": "fused_topk", "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/fused_topk.cu",
        "replaces": "predictionio_tpu/ops/fused_topk.py:206",
        "launches": serve["launches"],
        "max_abs_err": max(err, serve["max_abs_err"], wire["max_abs_err"],
                           fleet["table_max_abs_err"],
                           storage["model"]["table_max_abs_err"],
                           chaos["max_abs_err"]),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"], "bucket": 64,
        "wire_launches": wire["launches"],
        "obs_launches": wire["obs"]["launches"],
        "fleet_launches": fleet["launches"],
        "storage_launches": storage["launches"],
        "tiered_launches": tiered["launches"],
        "trained_model_launches": served["launches"],
        "lifecycle_launches": lifecycle["serve"]["launches"],
        "streaming_launches": streaming["launches"],
        "quickstart_launches": quickstart["launches"],
        "ingest_launches": ingest["launches"],
        "templates_launches": templates["templates_launches"],
        "classification_launches": classification["k1_launches"],
        "neural_launches": neural["k1_launches"],
        "quality_launches": quality["launches"],
        "pressure_launches": pressure["launches"],
        "elastic_launches": elastic["launches"],
        "chaos_launches": chaos["launches"],
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
        "neural_launches": neural["k2_launches"],
        "by_bucket": {str(b): r for b, r in timing_sh.items()}}]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
