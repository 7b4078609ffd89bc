"""BiMap: serializable bidirectional string<->dense-index mapping.

Parity target: `data/.../storage/BiMap.scala:28-135` — the universal bridge
every ALS template uses to turn entity IDs into contiguous matrix indexes
(`stringInt`/`stringLong` built via `zipWithUniqueId`). Unlike the
reference's nondeterministic RDD numbering, indexes here are assigned in
first-seen order, so a BiMap built from the same event stream is
deterministic — which keeps checkpoints and evals reproducible.

A copy of `predictionio_tpu/ingest/bimap.py`: the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, Iterator, List, Optional


class BiMap:
    """Immutable bidirectional map str -> dense int index [0, n)."""

    __slots__ = ("_fwd", "_inv")

    def __init__(self, forward: Dict[str, int]):
        self._fwd = dict(forward)
        self._inv: Optional[List[str]] = None

    @staticmethod
    def from_keys(keys: Iterable[str]) -> "BiMap":
        """Dense indexes in first-seen order (BiMap.stringInt analog)."""
        fwd: Dict[str, int] = {}
        for k in keys:
            if k not in fwd:
                fwd[k] = len(fwd)
        return BiMap(fwd)

    def __len__(self) -> int:
        return len(self._fwd)

    def __contains__(self, key: str) -> bool:
        return key in self._fwd

    def __iter__(self) -> Iterator[str]:
        return iter(self._fwd)

    def __call__(self, key: str) -> int:
        """Apply; KeyError on unknown key (BiMap.apply)."""
        return self._fwd[key]

    def get(self, key: str, default: Optional[int] = None) -> Optional[int]:
        return self._fwd.get(key, default)

    def inverse(self, index: int) -> str:
        """Index -> original key (BiMap.inverse)."""
        inv = self._inverse_list()
        return inv[index]

    def _inverse_list(self) -> List[str]:
        if self._inv is None:
            inv = [""] * len(self._fwd)
            for k, i in self._fwd.items():
                inv[i] = k
            self._inv = inv
        return self._inv

    def keys(self) -> List[str]:
        return list(self._fwd.keys())

    def to_dict(self) -> Dict[str, int]:
        return dict(self._fwd)

    # -- serialization (checkpointed alongside model arrays) ---------------
    def to_json(self) -> str:
        return json.dumps(self._inverse_list())

    @staticmethod
    def from_json(s: str) -> "BiMap":
        inv = json.loads(s)
        return BiMap({k: i for i, k in enumerate(inv)})

    def __eq__(self, other: object) -> bool:
        return isinstance(other, BiMap) and self._fwd == other._fwd

    def __repr__(self) -> str:
        return f"BiMap(n={len(self._fwd)})"
