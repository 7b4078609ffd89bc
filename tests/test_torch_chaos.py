"""The port's chaos drills (`predictionio_tpu_torch/resilience/
scenarios.py`) on the CPU: the catalog against the JAX package's, the
report text, `cli chaos`, the runner, and the five drills of one server
process (refresher-stall, refresher-die, lease-failover, mem-soft,
replica-kill), each ok on `device="cpu"`. The four fleet drills are in
`test_torch_chaos_fleet.py`, so that two workers share the drills' time.

Every test has its own SIGALRM limit."""

import io
import json
import signal
from contextlib import redirect_stdout

import pytest

from predictionio_tpu.resilience import scenarios as jsc
from predictionio_tpu.tools import loadsim as jloadsim
from predictionio_tpu_torch.resilience import scenarios as psc
from predictionio_tpu_torch.tools import loadsim as ploadsim

pytestmark = [pytest.mark.torch, pytest.mark.chaos]

LIMIT_S = 150


@pytest.fixture(autouse=True)
def _limit():
    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S}-s limit")
    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def trained():
    from predictionio_tpu_torch.data.storage import set_default
    out = psc.train_tiny(device="cpu")
    yield out
    set_default(None)


# -- the catalog -----------------------------------------------------------------

def _catalog(mod) -> dict:
    out = {}
    for name in mod.names():
        sc = mod.get(name)
        out[name] = {
            "description": sc.description, "duration_s": sc.duration_s,
            "steps": [(at, label) for at, label, _ in sc.steps],
            "invariants": [label for label, _ in sc.invariants],
            "watch": [(m, dict(labels)) for m, labels in sc.watch],
            "load": sc.load, "load_budget_s": sc.load_budget_s,
            "load_threads": sc.load_threads,
            "tight_roles": list(sc.tight_roles)}
    return out


def test_catalog_equals_the_jax_one():
    assert psc.names() == jsc.names() and len(psc.names()) == 9
    assert _catalog(psc) == _catalog(jsc)
    assert psc.FLEET_TIMINGS == jsc.FLEET_TIMINGS
    assert (psc.SCENARIO_STALL_S, psc.SCENARIO_SWEEP_S) == \
        (jsc.SCENARIO_STALL_S, jsc.SCENARIO_SWEEP_S)
    assert (psc.BUDGET_RATE, psc.BUDGET_BURST) == \
        (jsc.BUDGET_RATE, jsc.BUDGET_BURST)


@pytest.mark.parametrize("doc", ["_FLASH_DOC", "_HOTKEY_DOC"])
def test_loadsim_documents_and_schedules_equal_the_jax_ones(doc):
    mine, theirs = getattr(psc, doc), getattr(jsc, doc)
    assert mine == theirs
    ours = ploadsim.build_schedule(ploadsim.scenario_from_dict(mine))
    jax_sched = jloadsim.build_schedule(jloadsim.scenario_from_dict(theirs))
    assert len(ours) == len(jax_sched) > 0
    for a, b in zip(ours, jax_sched):
        assert (a.t, a.app, a.user, a.shape) == (b.t, b.app, b.user, b.shape)


@pytest.mark.parametrize("ok", [True, False])
def test_report_text_and_json_equal_the_jax_ones(ok):
    kw = dict(name="mem-soft", ok=ok, requests=1234, failures=0 if ok else 3,
              elapsed_s=6.04321,
              violations=[] if ok else ["bounded state trimmed: none"],
              notes={"trimmed_bytes": 4096, "loadsim_p999_ms": 12.5,
                     "a_note": "x"})
    mine, theirs = psc.ScenarioReport(**kw), jsc.ScenarioReport(**kw)
    assert psc.format_report(mine) == jsc.format_report(theirs)
    assert mine.to_json() == theirs.to_json()


def _cli_out(main, argv) -> tuple:
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_cli_chaos_list_prints_the_jax_json():
    from predictionio_tpu.cli.main import main as jmain
    from predictionio_tpu_torch.cli.main import main as pmain
    mine, theirs = _cli_out(pmain, ["chaos", "list"]), \
        _cli_out(jmain, ["chaos", "list"])
    assert mine == theirs and mine[0] == 0
    assert [d["name"] for d in json.loads(mine[1])] == psc.names()


# -- the runner ------------------------------------------------------------------

def test_violated_invariant_is_loud():
    sc = psc.Scenario(
        name="always-red", description="an invariant that always fails",
        duration_s=0.0, setup=lambda ctx: None, steps=(),
        invariants=(("never true", lambda ctx: "deliberate violation"),),
        load=False)
    report = psc.run(sc, trained=(None, None, None), device="cpu")
    assert not report.ok
    assert any("deliberate violation" in v for v in report.violations)


def test_step_crash_is_a_violation():
    def bad_step(ctx):
        raise RuntimeError("scripted explosion")

    sc = psc.Scenario(
        name="crashy", description="a step that crashes", duration_s=0.0,
        setup=lambda ctx: None, steps=((0.0, "boom", bad_step),),
        invariants=(), load=False)
    report = psc.run(sc, trained=(None, None, None), device="cpu")
    assert not report.ok
    assert any("scripted explosion" in v for v in report.violations)


def test_cli_rejects_unknown_scenario():
    from predictionio_tpu_torch.cli.main import main
    assert main(["chaos", "run", "no-such-scenario"]) == 2


def test_chaos_run_without_a_device_needs_cuda():
    """No fallback: without `--device cpu` the drills' model trains on
    the card, which this host lacks."""
    import torch
    from predictionio_tpu_torch.cli.main import main
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["chaos", "run", "refresher-die"])


@pytest.mark.parametrize("name", ["refresher-stall", "refresher-die",
                                  "lease-failover", "mem-soft",
                                  "replica-kill"])
def test_drill_is_ok_on_the_cpu(trained, name):
    report = psc.run(name, trained=trained, device="cpu")
    assert report.ok, report.violations
    assert report.failures == 0 and report.requests > 0
    if name == "lease-failover":
        assert report.notes["killed_leader_port"] > 0
    if name == "mem-soft":
        assert report.notes["trimmed_bytes"] > 0
    if name == "replica-kill":
        assert report.notes["recovery_s"] > 0
