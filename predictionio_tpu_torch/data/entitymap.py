"""Typed entity collections keyed by entity id, with dense indexes.

The port of `predictionio_tpu/data/entitymap.py` (EntityMap.scala's
`EntityIdIxMap` and `EntityMap`, and their builder
`PEvents.extractEntityMap`, PEvents.scala:136+): a map entityId -> T
whose ids also carry contiguous indexes [0, n), so that model code
addresses entities as dense array rows.
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, Iterator, Optional, TypeVar

from predictionio_tpu_torch.data.event import PropertyMap
from predictionio_tpu_torch.ingest.bimap import BiMap

T = TypeVar("T")


class EntityIdIxMap:
    """entityId <-> dense index (EntityMap.scala's EntityIdIxMap, a
    BiMap[String, Long])."""

    def __init__(self, bimap: BiMap):
        self._bimap = bimap

    @staticmethod
    def from_ids(ids) -> "EntityIdIxMap":
        return EntityIdIxMap(BiMap.from_keys(ids))

    def __call__(self, entity_id: str) -> int:
        return self._bimap(entity_id)

    def __contains__(self, entity_id: str) -> bool:
        return entity_id in self._bimap

    def get(self, entity_id: str) -> Optional[int]:
        return self._bimap.get(entity_id)

    def ix_to_id(self, ix: int) -> str:
        return self._bimap.inverse(ix)

    def __len__(self) -> int:
        return len(self._bimap)

    @property
    def bimap(self) -> BiMap:
        return self._bimap


class EntityMap(Generic[T]):
    """An immutable entityId -> T collection with dense indexes
    (EntityMap.scala: apply, getOrElse, contains, size, ixToId)."""

    def __init__(self, data: Dict[str, T],
                 id_to_ix: Optional[EntityIdIxMap] = None):
        self._data = dict(data)
        self._ids = id_to_ix or EntityIdIxMap.from_ids(self._data.keys())

    def __call__(self, entity_id: str) -> T:
        """EntityMap.apply: KeyError on an unknown id."""
        return self._data[entity_id]

    def get(self, entity_id: str, default: Optional[T] = None) -> Optional[T]:
        return self._data.get(entity_id, default)

    def __contains__(self, entity_id: str) -> bool:
        return entity_id in self._data

    def __len__(self) -> int:
        return len(self._data)

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def items(self):
        return self._data.items()

    @property
    def id_to_ix(self) -> EntityIdIxMap:
        return self._ids

    def by_ix(self, ix: int) -> T:
        """Dense index -> value (ixToId, then apply)."""
        return self._data[self._ids.ix_to_id(ix)]

    def map_values(self, fn: Callable[[T], object]) -> "EntityMap":
        """The same ids and indexes, the values mapped."""
        return EntityMap({k: fn(v) for k, v in self._data.items()},
                         self._ids)


def entity_map_from_properties(registry, app_name: str, *,
                               entity_type: str,
                               extract: Optional[Callable[[PropertyMap], T]]
                               = None,
                               channel_name: Optional[str] = None,
                               **filters) -> EntityMap:
    """Every entity of a type with its aggregated `$set` / `$unset` /
    `$delete` properties as an EntityMap (PEvents.extractEntityMap);
    `extract` maps each PropertyMap to the model's value (omitted, the
    values are the PropertyMaps)."""
    from predictionio_tpu_torch.data.store import aggregate_properties

    props = aggregate_properties(registry, app_name,
                                 entity_type=entity_type,
                                 channel_name=channel_name, **filters)
    return EntityMap({eid: (extract(pm) if extract is not None else pm)
                      for eid, pm in props.items()})
