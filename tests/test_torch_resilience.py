"""The port's resilience primitives (`predictionio_tpu_torch/
resilience/`) on the CPU, held against the JAX package's: the
`X-PIO-Deadline-Ms` parsing (the same header values give the same
deadline or the same refusal), the deadline's scope and its cut of a
retry schedule, `InflightLimiter` (the port sheds 503 where the JAX
limiter answers 429; ROADMAP.md, "by design"), and the fault seams (the
same rules fire at the same seams, counted in
`pio_faults_injected_total`). No test asserts a rate."""

import threading
import time

import pytest

from predictionio_tpu import resilience as jres
from predictionio_tpu_torch import resilience as pres
from predictionio_tpu_torch.obs import get_registry

pytestmark = pytest.mark.torch

HEADERS = [None, "", "100", "2500.5", "1e3", "0", "-5", "abc", " 7 ",
           "nan", "0.001"]


def _parse(mod, value, default_ms):
    try:
        d = mod.deadline_from_header(value, default_ms)
    except ValueError as e:
        return "error", str(e)
    if d is None:
        return None
    return "deadline", round(d.remaining(), 1)


@pytest.mark.parametrize("value", HEADERS)
@pytest.mark.parametrize("default_ms", [0, 250])
def test_deadline_header_parses_as_the_jax_one(value, default_ms):
    assert pres.DEADLINE_HEADER == jres.DEADLINE_HEADER
    assert _parse(pres, value, default_ms) == _parse(jres, value,
                                                     default_ms)


def test_deadline_scope_and_expiry():
    assert pres.current_deadline() is None
    d = pres.Deadline.after_ms(10_000)
    with pres.deadline_scope(d):
        assert pres.current_deadline() is d
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            pres.current_deadline()))
        t.start()
        t.join(timeout=10)
        assert seen == [None]          # the scope is the thread's own
    assert pres.current_deadline() is None
    gone = pres.Deadline.after_s(-1.0)
    assert gone.expired and gone.remaining() == 0.0
    with pytest.raises(pres.DeadlineExceeded):
        gone.check("q")


def test_retry_stops_when_the_deadline_cannot_cover_the_backoff():
    calls = []

    def flaky():
        calls.append(1)
        raise OSError("down")

    policy = pres.RetryPolicy(attempts=5, base_delay=1.0, jitter=0.0)
    with pres.deadline_scope(pres.Deadline.after_ms(50)):
        with pytest.raises(OSError):
            pres.call_with_retry(flaky, policy=policy,
                                 sleep=lambda s: None)
    assert len(calls) == 1
    calls.clear()
    with pytest.raises(OSError):
        pres.call_with_retry(flaky, policy=policy, sleep=lambda s: None)
    assert len(calls) == 5


def test_inflight_limiter_sheds_503_past_its_cap():
    lim = pres.InflightLimiter(2, surface="s", retry_after=3.0)
    jlim = jres.InflightLimiter(2, surface="s", retry_after=3.0)
    with lim, lim, jlim, jlim:
        assert lim.inflight == jlim.inflight == 2
        with pytest.raises(pres.OverloadedError) as ei:
            with lim:
                pass
        with pytest.raises(jres.OverloadedError) as ej:
            with jlim:
                pass
    assert lim.inflight == 0
    assert (ei.value.status, ej.value.status) == (503, 429)
    assert ei.value.message == ej.value.message
    assert ei.value.retry_after == ej.value.retry_after == 3.0
    unlimited = pres.InflightLimiter(0)
    for _ in range(100):
        unlimited.__enter__()
    assert unlimited.inflight == 0     # 0 = no cap, nothing counted


SEAMS = ["serve.predict.0:ALSAlgorithm", "serve.predict.1:X",
         "serve.predicted", "deploy.prepare", "deploy", "storage.PIO.x"]


@pytest.mark.parametrize("armed", ["serve.predict", "serve.predict.0",
                                   "deploy.prepare", "storage"])
def test_fault_seams_fire_where_the_jax_seams_fire(armed):
    fired = {}
    for name, mod in (("torch", pres), ("jax", jres)):
        inj = mod.FaultInjector()
        rule = inj.arm(armed, error=RuntimeError, times=2)
        hits = []
        for seam in SEAMS * 2:
            try:
                inj.check(seam)
                hits.append(False)
            except RuntimeError:
                hits.append(True)
        fired[name] = (hits, rule.hits, inj.dropped(armed))
    assert fired["torch"] == fired["jax"]


def test_fault_rules_latency_drop_torn_and_counter():
    inj = pres.faults()
    before = get_registry().value("pio_faults_injected_total",
                                  seam="deploy.prepare")
    try:
        inj.arm("deploy.prepare", latency=0.05, times=1)
        t0 = time.perf_counter()
        inj.check("deploy.prepare")
        assert time.perf_counter() - t0 >= 0.04
        inj.check("deploy.prepare")       # exhausted: passes at once
        inj.arm("net.x", times=1)
        assert inj.dropped("net.x.heartbeat") is True
        assert inj.dropped("net.x.heartbeat") is False
        inj.arm("blob", torn=0.6)
        assert inj.torn_fraction("blob.write") == 0.6
        inj.check("blob.write")           # torn rules never raise
    finally:
        inj.clear()
    assert not inj.armed
    assert get_registry().value("pio_faults_injected_total",
                                seam="deploy.prepare") == before + 1
