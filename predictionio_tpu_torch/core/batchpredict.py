"""Offline bulk inference: `pio batchpredict`.

The port of `predictionio_tpu/core/batchpredict.py`
(`core/.../workflow/BatchPredict.scala:145-229`): one JSON query per
input line runs the serve chain (supplement -> every algorithm's
`batch_predict` -> serve) and one JSON line `{"query", "prediction"}`
per query is written, in the input's order.

The instance loads through `CoreWorkflow.prepare_deploy` with the
deploy's warmup (buckets up to `cli deploy`'s default batch_max, 64),
so a chunk of queries goes through the warmed plan, that is through the
fused top-k kernel (K1), which splits it at the largest bucket.
"""

from __future__ import annotations

import json
from typing import Iterable, Iterator, List

from predictionio_tpu_torch.core.engine import Engine
from predictionio_tpu_torch.core.params import extract_params
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.core.workflow import CoreWorkflow
from predictionio_tpu_torch.serving.server import _Deployment, to_jsonable


WARM_BATCH_MAX = 64


def load_deployment(engine: Engine, instance, ctx: RuntimeContext
                    ) -> _Deployment:
    """The instance's models on `ctx.device`, warmed as a deploy warms
    them, as the deployment the prediction server would serve."""
    timings: dict = {}
    algos, models, serving = CoreWorkflow.prepare_deploy(
        engine, instance, ctx, warm_batch_max=WARM_BATCH_MAX,
        timings=timings)
    return _Deployment(algos, models, serving, engine=engine,
                       instance=instance, timings=timings)


def predict_lines(dep: _Deployment, lines: Iterable[str], *,
                  chunk_size: int = 1024) -> Iterator[str]:
    """One JSON result line per non-blank query line, in order, the
    queries run `chunk_size` at a time through `dep.predict_batch`."""

    def flush(payloads: List[dict]) -> Iterator[str]:
        queries = [extract_params(dep.query_class, p)
                   if dep.query_class is not None else p
                   for p in payloads]
        for payload, prediction in zip(payloads,
                                       dep.predict_batch(queries)):
            yield json.dumps({"query": payload,
                              "prediction": to_jsonable(prediction)})

    chunk: List[dict] = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        chunk.append(json.loads(line))
        if len(chunk) >= chunk_size:
            yield from flush(chunk)
            chunk = []
    if chunk:
        yield from flush(chunk)


def batch_predict_lines(engine: Engine, instance, ctx: RuntimeContext,
                        lines: Iterable[str], *,
                        chunk_size: int = 1024) -> Iterator[str]:
    """Yield one JSON result line per input query line, in order."""
    yield from predict_lines(load_deployment(engine, instance, ctx), lines,
                             chunk_size=chunk_size)


def run_batch_predict(engine: Engine, instance, ctx: RuntimeContext, *,
                      input_path: str, output_path: str,
                      chunk_size: int = 1024) -> int:
    """File to file (BatchPredict.scala main); returns the number of
    predictions written."""
    n = 0
    with open(input_path) as fin, open(output_path, "w") as fout:
        for out_line in batch_predict_lines(engine, instance, ctx, fin,
                                            chunk_size=chunk_size):
            fout.write(out_line + "\n")
            n += 1
    return n
