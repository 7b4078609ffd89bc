"""The port's event model against the JAX package's: `Event.from_api_json`
accepts and refuses the same API-JSON events with the same messages,
`to_api_json` round-trips to the same JSON, and `EventValidation` gives
the same verdict on events built directly (reserved names, the `pio_`
prefix, entity and target pairs)."""

import pytest

from predictionio_tpu.data import event as jev
from predictionio_tpu_torch.data import event as pev

pytestmark = pytest.mark.torch

_T = "2020-01-02T03:04:05.678Z"


def _base(**kw):
    e = {"event": "rate", "entityType": "user", "entityId": "u1",
         "targetEntityType": "item", "targetEntityId": "i1",
         "properties": {"rating": 4.5}, "eventTime": _T,
         "creationTime": _T, "eventId": "e1"}
    e.update(kw)
    return {k: v for k, v in e.items() if v is not _DROP}


_DROP = object()

# API-JSON bodies: valid ones first, then the refusals
CORPUS = [
    _base(),
    _base(properties={"a": [1, 2, {"b": None}], "c": "x", "d": True}),
    _base(targetEntityType=_DROP, targetEntityId=_DROP, event="view"),
    _base(event="$set", targetEntityType=_DROP, targetEntityId=_DROP,
          properties={"name": "x"}),
    _base(event="$unset", targetEntityType=_DROP, targetEntityId=_DROP,
          properties={"name": None}),
    _base(event="$delete", targetEntityType=_DROP, targetEntityId=_DROP,
          properties=_DROP),
    _base(entityType="pio_pr"),
    _base(tags=["a", "b"], prId="p1"),
    _base(eventTime="2020-01-02T03:04:05+02:00"),
    _base(eventTime=1577934245678),
    _base(eventTime="2020-01-02T03:04:05.678912"),
    _base(eventId=_DROP),
    _base(event=""),
    _base(entityType=""),
    _base(entityId=""),
    _base(entityId=_DROP),
    _base(entityId=7),
    _base(targetEntityType=""),
    _base(targetEntityId=""),
    _base(targetEntityId=_DROP),
    _base(targetEntityType=_DROP),
    _base(event="$weird", targetEntityType=_DROP, targetEntityId=_DROP),
    _base(event="pio_x", targetEntityType=_DROP, targetEntityId=_DROP),
    _base(event="$set"),
    _base(event="$unset", targetEntityType=_DROP, targetEntityId=_DROP,
          properties={}),
    _base(entityType="$user"),
    _base(entityType="pio_user"),
    _base(targetEntityType="pio_item"),
    _base(targetEntityType="$item"),
    _base(properties={"pio_x": 1}),
    _base(properties={"$x": 1}),
    _base(properties=[1, 2]),
    _base(tags="a"),
    _base(tags=["a", 1]),
    _base(prId=3),
    _base(eventTime="not a time"),
]


def _verdict(mod, obj):
    try:
        e = mod.Event.from_api_json(obj)
    except (ValueError, TypeError) as err:
        return ("refused", type(err).__name__, str(err))
    out = e.to_api_json()
    if "eventId" not in obj:   # the store assigns ids; drop the draw
        out.pop("eventId", None)
    back = mod.Event.from_api_json(out).to_api_json()
    if "eventId" not in obj:
        back.pop("eventId", None)
    assert back == out
    # the same event, checked again directly
    mod.EventValidation.validate(e)
    return ("valid", out, e.event_time_millis)


@pytest.mark.parametrize("obj", CORPUS, ids=range(len(CORPUS)))
def test_api_json_and_validation_match_the_jax_package(obj):
    want = _verdict(jev, obj)
    got = _verdict(pev, obj)
    assert got == want
    assert (want[0] == "valid") == (CORPUS.index(obj) < 12)
    if want[0] == "valid" and obj.get("eventTime") == _T:
        assert pev.format_time(pev.parse_time(_T)) == _T
