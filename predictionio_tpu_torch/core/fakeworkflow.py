"""FakeWorkflow: arbitrary code run through the workflow's bookkeeping.

The port of `predictionio_tpu/core/fakeworkflow.py`
(FakeWorkflow.scala:33-120, whose `FakeRun` wraps a `SparkContext =>
Unit` function as a fake engine and evaluator): here the function takes
a `RuntimeContext` and runs under an EvaluationInstance row, RUNNING
while it runs and COMPLETED with the result's text after it.
"""

from __future__ import annotations

import traceback
from typing import Any, Callable

from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.data.event import utcnow
from predictionio_tpu_torch.data.storage.base import (
    EvaluationInstance, EvaluationInstanceStatus)


def fake_run(fn: Callable[[RuntimeContext], Any],
             ctx: RuntimeContext, *, label: str = "FakeRun") -> Any:
    """`fn(ctx)` under an EvaluationInstance row (FakeWorkflow.runEval
    and FakeEvalResult); a failure leaves the row RUNNING and
    raises."""
    instances = ctx.registry.get_meta_data_evaluation_instances()
    row = EvaluationInstance(
        id="", status=EvaluationInstanceStatus.RUNNING,
        start_time=utcnow(), end_time=utcnow(),
        evaluation_class=label, batch=ctx.workflow_params.batch)
    iid = instances.insert(row)
    row = row.with_(id=iid)
    try:
        result = fn(ctx)
        instances.update(row.with_(
            status=EvaluationInstanceStatus.COMPLETED, end_time=utcnow(),
            evaluator_results=repr(result)[:1000]))
        return result
    except Exception:
        traceback.print_exc()
        instances.update(row.with_(end_time=utcnow()))
        raise
