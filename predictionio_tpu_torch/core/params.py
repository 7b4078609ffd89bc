"""Typed parameter classes and JSON extraction.

The port of `predictionio_tpu/core/params.py`: the `Params` marker,
`EmptyParams`, the strict dataclass-driven `extract_params` that turns a
query JSON into the template's `Query` and an engine.json variant into
component params, `params_to_json` (eval's per-stage cache key) and
`EngineParams`.
"""

from __future__ import annotations

import collections.abc as cabc
import dataclasses
import json
import typing
from typing import (Any, Dict, Mapping, Optional, Sequence, Tuple, Type,
                    TypeVar)


class Params:
    """Marker base for component parameter classes; subclasses are
    `@dataclass`es. (Params.scala:25)"""


@dataclasses.dataclass(frozen=True)
class EmptyParams(Params):
    """(EmptyParams, Params.scala:30)"""


T = TypeVar("T")


class ParamsError(ValueError):
    """Extraction failure with a JSON-path-qualified message."""


def _type_name(tp) -> str:
    return getattr(tp, "__name__", str(tp))


# typing.get_type_hints resolves every annotation string on every call,
# and each served query extracts its Query dataclass: memoize per class
_HINTS_CACHE: Dict[type, Dict[str, Any]] = {}


def _hints_for(cls: type) -> Dict[str, Any]:
    h = _HINTS_CACHE.get(cls)
    if h is None:
        h = _HINTS_CACHE[cls] = typing.get_type_hints(cls)
    return h


def extract_params(cls: Type[T], obj: Any, path: str = "$") -> T:
    """Build `cls` (a Params dataclass) from parsed JSON `obj`. Unknown
    keys are rejected."""
    if isinstance(obj, str):
        obj = json.loads(obj) if obj.strip() else {}
    if obj is None:
        obj = {}
    if not isinstance(obj, Mapping):
        raise ParamsError(
            f"{path}: expected an object for {_type_name(cls)}, "
            f"got {type(obj).__name__}")
    if not dataclasses.is_dataclass(cls):
        raise ParamsError(f"{path}: {_type_name(cls)} is not a params dataclass")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(obj) - set(fields)
    if unknown:
        raise ParamsError(
            f"{path}: unknown field(s) {sorted(unknown)} for "
            f"{_type_name(cls)}; known: {sorted(fields)}")
    hints = _hints_for(cls)
    kwargs: Dict[str, Any] = {}
    for name, f in fields.items():
        if name in obj:
            kwargs[name] = _coerce(hints.get(name, Any), obj[name],
                                   f"{path}.{name}")
        elif (f.default is dataclasses.MISSING
              and f.default_factory is dataclasses.MISSING):
            raise ParamsError(
                f"{path}: missing required field '{name}' "
                f"({_type_name(hints.get(name, Any))}) for {_type_name(cls)}")
    try:
        return cls(**kwargs)
    except (TypeError, ValueError) as e:
        raise ParamsError(f"{path}: cannot construct {_type_name(cls)}: {e}")


def _coerce(tp, value: Any, path: str) -> Any:
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if tp is Any or tp is None:
        return value
    if origin is typing.Union:
        if value is None:
            if type(None) in args:
                return None
            raise ParamsError(f"{path}: null not allowed for {tp}")
        errors = []
        for cand in (a for a in args if a is not type(None)):
            try:
                return _coerce(cand, value, path)
            except ParamsError as e:
                errors.append(str(e))
        raise ParamsError(f"{path}: no Union arm matched: {errors}")
    if dataclasses.is_dataclass(tp):
        return extract_params(tp, value, path)
    # get_origin(Sequence[str]) is collections.abc.Sequence; Mapping is
    # checked first since dict-like abcs subclass Collection
    is_mapping_origin = (isinstance(origin, type)
                         and issubclass(origin, cabc.Mapping))
    is_seq_origin = (isinstance(origin, type) and not is_mapping_origin
                     and issubclass(origin, cabc.Sequence))
    if is_seq_origin or tp in (list, tuple):
        if not isinstance(value, (list, tuple)):
            raise ParamsError(
                f"{path}: expected array, got {type(value).__name__}")
        elem = args[0] if args else Any
        out = [_coerce(elem, v, f"{path}[{i}]") for i, v in enumerate(value)]
        return tuple(out) if origin is tuple or tp is tuple else out
    if is_mapping_origin or tp is dict:
        if not isinstance(value, Mapping):
            raise ParamsError(
                f"{path}: expected object, got {type(value).__name__}")
        vt = args[1] if len(args) == 2 else Any
        return {k: _coerce(vt, v, f"{path}.{k}") for k, v in value.items()}
    if tp is bool:
        if not isinstance(value, bool):
            raise ParamsError(
                f"{path}: expected bool, got {type(value).__name__}")
        return value
    if tp is int:
        if isinstance(value, bool) or not isinstance(value, int):
            if isinstance(value, float) and value.is_integer():
                return int(value)
            raise ParamsError(
                f"{path}: expected int, got {type(value).__name__}")
        return value
    if tp is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ParamsError(
                f"{path}: expected number, got {type(value).__name__}")
        return float(value)
    if tp is str:
        if not isinstance(value, str):
            raise ParamsError(
                f"{path}: expected string, got {type(value).__name__}")
        return value
    return value


def params_to_json(p: Optional[Params]) -> str:
    """A params dataclass as sorted-key JSON."""
    if p is None:
        return "{}"
    return json.dumps(dataclasses.asdict(p), sort_keys=True)


@dataclasses.dataclass(frozen=True)
class EngineParams:
    """Named component params for one engine variant
    (EngineParams.scala:25-65): (component name, params) pairs. An
    `EmptyParams` placeholder means "that component's default params"."""
    data_source_params: Tuple[str, Params] = ("", EmptyParams())
    preparator_params: Tuple[str, Params] = ("", EmptyParams())
    algorithm_params_list: Sequence[Tuple[str, Params]] = (
        ("", EmptyParams()),)
    serving_params: Tuple[str, Params] = ("", EmptyParams())
