"""The port's four fleet chaos drills (`predictionio_tpu_torch/resilience/
scenarios.py`) on the CPU, counterparts of the JAX package's elastic
scenario gates: flash-crowd (1 -> 2 -> 1 under a loadsim flash),
diurnal-1-N-1 (1 -> 3 -> 1), hot-key (a loadsim pivot onto one user) and
handoff-budget (one rate-limited tenant across a leader crash), each ok
on `device="cpu"`. The runner and the other drills are in
`test_torch_chaos.py`.

Every test has its own SIGALRM limit."""

import signal

import pytest

from predictionio_tpu_torch.resilience import scenarios as psc

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


def test_flash_crowd_scales_one_to_n_to_one(trained):
    report = psc.run("flash-crowd", trained=trained, device="cpu")
    assert report.ok, report.violations
    assert report.failures == 0
    assert report.notes["loadsim_errors"] == 0
    assert report.notes["peak_children"] >= 2


def test_diurnal_swings_one_to_three_to_one(trained):
    report = psc.run("diurnal-1-N-1", trained=trained, device="cpu")
    assert report.ok, report.violations
    assert report.failures == 0
    assert report.notes["peak_children"] >= 3


def test_hot_key_pivot_serves_clean(trained):
    report = psc.run("hot-key", trained=trained, device="cpu")
    assert report.ok, report.violations
    assert report.notes["loadsim_errors"] == 0
    assert 0.2 <= report.notes["hot_share"] <= 0.6


def test_handoff_admits_at_most_one_budget(trained):
    report = psc.run("handoff-budget", trained=trained, device="cpu")
    assert report.ok, report.violations
    assert report.notes["admitted_total"] \
        <= report.notes["admitted_budget"]
    # the standby actually served (the gate is not vacuous)
    assert report.notes["admitted_standby"] >= 1


def test_good_evidence_never_readmits_a_retiring_member():
    """A probe or a beat that began before a retire must not put the
    retiring member back into the rotation when it lands after it (the
    race behind a retirement read as an eject)."""
    from predictionio_tpu_torch.obs.metrics import MetricsRegistry
    from predictionio_tpu_torch.serving.fleet import FleetConfig, FleetServer
    router = FleetServer(None, fleet=FleetConfig(replicas=0), port=0,
                         metrics=MetricsRegistry())
    rep = router._add_member("127.0.0.1", 9)
    router._admit(rep)
    assert rep.admitted and rep.state == "serving"
    assert router.retire_member(rep)
    router._maybe_admit(rep)          # the late probe's good evidence
    assert not rep.admitted and rep.state == "retiring"
    with rep.lock:
        rep.state = "reloading"       # a roll re-admits its member itself
    router._admit(rep)
    assert rep.admitted and rep.state == "serving"
