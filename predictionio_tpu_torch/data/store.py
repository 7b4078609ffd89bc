"""Engine-facing event store facade.

The port of `app_name_to_id`, `find_events`, `rating_columns`,
`pair_columns`, `aggregate_properties` and `find_by_entity` from
`predictionio_tpu/data/store.py` (PEventStore.scala / LEventStore.scala):
engines address data by app name and channel name, which resolve to
ids (store/Common.scala appNameToId) before the `EventStore` DAO runs.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence

from predictionio_tpu_torch.data.event import Event, PropertyMap


class AppNotFoundError(ValueError):
    pass


def app_name_to_id(registry, app_name: str,
                   channel_name: Optional[str] = None):
    """(app_id, channel_id) from names (store/Common.scala:33-59)."""
    app = registry.get_meta_data_apps().get_by_name(app_name)
    if app is None:
        raise AppNotFoundError(
            f"App {app_name!r} not found; create it with 'pio app new'")
    channel_id = None
    if channel_name is not None:
        channels = registry.get_meta_data_channels().get_by_appid(app.id)
        match = [c for c in channels if c.name == channel_name]
        if not match:
            raise AppNotFoundError(
                f"Channel {channel_name!r} not found for app {app_name!r}")
        channel_id = match[0].id
    return app.id, channel_id


def find_events(registry, app_name: str,
                channel_name: Optional[str] = None,
                **filters) -> Iterator[Event]:
    """PEventStore.find; `filters` pass through to `EventStore.find`."""
    app_id, channel_id = app_name_to_id(registry, app_name, channel_name)
    return registry.get_events().find(app_id, channel_id, **filters)


def rating_columns(registry, app_name: str,
                   channel_name: Optional[str] = None, **kwargs):
    """The columnar training read: `RatingColumns` scanned straight from
    the store (`ingest.pipeline.rating_columns_from_store`, which takes
    `kwargs`), equal to `RatingColumns.from_events(find_events(...))`."""
    from predictionio_tpu_torch.ingest.arrays import RatingColumns
    app_id, channel_id = app_name_to_id(registry, app_name, channel_name)
    return RatingColumns.from_store(
        registry.get_events(), app_id, channel_id, **kwargs)


def pair_columns(registry, app_name: str,
                 channel_name: Optional[str] = None, **kwargs):
    """The columnar `PairColumns` read (`ingest.pipeline.
    pair_columns_from_store`, which takes `kwargs`); see
    `rating_columns`."""
    from predictionio_tpu_torch.ingest.arrays import PairColumns
    app_id, channel_id = app_name_to_id(registry, app_name, channel_name)
    return PairColumns.from_store(
        registry.get_events(), app_id, channel_id, **kwargs)


def aggregate_properties(registry, app_name: str, *, entity_type: str,
                         channel_name: Optional[str] = None,
                         **filters) -> Dict[str, PropertyMap]:
    """PEventStore.aggregateProperties: `filters` pass through to
    `EventStore.aggregate_properties`."""
    app_id, channel_id = app_name_to_id(registry, app_name, channel_name)
    return registry.get_events().aggregate_properties(
        app_id, channel_id, entity_type=entity_type, **filters)


def find_by_entity(registry, app_name: str, *, entity_type: str,
                   entity_id: str, channel_name: Optional[str] = None,
                   event_names: Optional[Sequence[str]] = None,
                   limit: Optional[int] = None,
                   latest_first: bool = True) -> Iterator[Event]:
    """LEventStore.findByEntity: the serving-time read the e-commerce
    template makes inside predict (`ECommAlgorithm.scala:331-430`)."""
    app_id, channel_id = app_name_to_id(registry, app_name, channel_name)
    return registry.get_events().find(
        app_id, channel_id, entity_type=entity_type, entity_id=entity_id,
        event_names=event_names, limit=limit, reversed=latest_first)
