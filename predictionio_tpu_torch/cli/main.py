"""Command line of the port: `train` and `deploy` a recommendation model.

    python -m predictionio_tpu_torch.cli train --ratings r.npz \
        --model-out m.npz [--variant engine.json] [--device cpu]
    python -m predictionio_tpu_torch.cli deploy --model m.npz --port 8000 \
        [--device cpu] [--batch-max 64] [--items-on-host]

The ratings file is an `.npz` written by
`ingest.arrays.RatingColumns.save_npz` (the stand-in for the event store
until it is ported); `--variant` is an engine.json whose algorithm
params set rank, iterations, lambda_ and seed. The model file is an
`.npz` written by `ops.als.ALSModel.save_npz` (two factor matrices and
both id lists). Both commands run on CUDA unless `--device cpu` is
given, and refuse to start without CUDA otherwise. `--items-on-host`
keeps the item master in host RAM, so that a catalog past the card's
budget tiers (or, over two or more cards, shards) instead of being
loaded whole onto one card.
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import sys
import threading
from pathlib import Path
from typing import Mapping, Optional, Sequence, Tuple, Union

from predictionio_tpu_torch.core.params import EngineParams
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.core.workflow import prepare_deploy
from predictionio_tpu_torch.ingest.arrays import RatingColumns
from predictionio_tpu_torch.models.recommendation import RecommendationEngine
from predictionio_tpu_torch.ops.als import ALSModel, load_npz
from predictionio_tpu_torch.serving.server import (PredictionServer,
                                                   _Deployment)


def train(ratings: Union[str, Path], model_out: Union[str, Path], *,
          variant: Optional[Mapping] = None, device=None
          ) -> Tuple[ALSModel, dict]:
    """Train the recommendation engine on the ratings file `ratings`
    through `Engine.train` (params from the engine.json `variant`, a
    parsed mapping; None = the defaults) on `device` (None = cuda), and
    write the model to `model_out` with `ALSModel.save_npz`. Returns the
    model and the run's phase timings."""
    engine = RecommendationEngine.apply()
    params = (engine.engine_params_from_variant(variant)
              if variant is not None else EngineParams())
    ctx = RuntimeContext(device=device,
                         ratings=RatingColumns.load_npz(ratings))
    model, = engine.train(ctx, params)
    model.save_npz(model_out)
    return model, dict(ctx.phase_timings)


def deploy(model: ALSModel, *, host: str = "127.0.0.1", port: int = 8000,
           batch_max: int = 64, window_s: float = 0.002,
           mesh=None) -> PredictionServer:
    """Warm `model` for serving (kernel built, every bucket up to
    `batch_max` launched once) and start a `PredictionServer` on it in a
    background thread; returns the running server. `mesh`, an
    `ops.topk_sharded.ServeMesh`, shards the catalog over its devices
    (`ServeMesh((torch.device("cuda", 0),) * 3, forced=True)` serves
    three shards from one card); None shards only over two or more
    local cards, as `serve_mesh_from_conf` decides. A sharded or tiered
    plan takes the device state: `model.item_factors` is moved to host
    RAM (`ALSAlgorithm.warm_serving`)."""
    algos, models, serving = prepare_deploy(
        RecommendationEngine.apply(), [model], warm_batch_max=batch_max,
        mesh=mesh)
    server = PredictionServer(_Deployment(algos, models, serving),
                              host=host, port=port, batch_max=batch_max,
                              window_s=window_s)
    server.start()
    return server


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="predictionio_tpu_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)
    tr = sub.add_parser("train", help="train a model on a ratings file")
    tr.add_argument("--ratings", required=True, help="ratings .npz file")
    tr.add_argument("--model-out", required=True, help="model .npz to write")
    tr.add_argument("--variant", default=None,
                    help="engine.json with the algorithm params")
    tr.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    dep = sub.add_parser("deploy", help="serve /queries.json for a model")
    dep.add_argument("--model", required=True, help="model .npz file")
    dep.add_argument("--ip", default="127.0.0.1")
    dep.add_argument("--port", type=int, default=8000)
    dep.add_argument("--device", default=None,
                     help="torch device (default cuda)")
    dep.add_argument("--batch-max", type=int, default=64)
    dep.add_argument("--items-on-host", action="store_true",
                     help="keep the item factors in host RAM; the serving "
                          "plan places what it needs on the device")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    if args.command == "train":
        variant = (json.loads(Path(args.variant).read_text())
                   if args.variant else None)
        model, timings = train(args.ratings, args.model_out,
                               variant=variant, device=args.device)
        print(json.dumps({"model": args.model_out,
                          "users": len(model.users),
                          "items": len(model.items),
                          "rank": model.user_factors.shape[1],
                          "device": str(model.device),
                          "timings": timings}), flush=True)
        return 0

    model = load_npz(args.model, device=args.device,
                     items_device="cpu" if args.items_on_host else None)
    server = deploy(model, host=args.ip, port=args.port,
                    batch_max=args.batch_max)
    print(f"serving {args.model} on http://{args.ip}:{server.port} "
          f"({model.device})", flush=True)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
