"""Model persistence: the per-instance model blob.

The port of `predictionio_tpu/core/persistence.py` (the Kryo blob of
CoreWorkflow.scala:76-81, `PersistentModel`/`PersistentModelLoader`,
PersistentModel.scala:30-115, and `PersistentModelManifest`): one
pickle per engine instance holding one entry per algorithm. A model
that implements `PersistentModel` saves itself and leaves its manifest
in the blob; an algorithm with `persist_model = False` leaves a
`RetrainMarker`, and deploy retrains it (Engine.scala:211-233).

Two differences from the JAX package:

  - Saving: a `torch.Tensor` on any device is pickled as a numpy array
    (`_TorchAwarePickler.reducer_override`) and comes back as a CPU
    tensor, so reading a blob needs no CUDA: a CPU process reads what
    the card wrote. Device placement is the deploy's decision
    (`ALSModel.to`).
  - Loading: a restricted unpickler admits only what the port's blobs
    name: classes of `predictionio_tpu_torch` and its tensor rebuilder,
    numpy's array, dtype and scalar rebuilders, torch's `Size`, `device`
    and dtypes, and a few builtin types. A blob that names
    `predictionio_tpu.*` (an instance the JAX package trained into a
    shared store) raises `ForeignModelError` instead of importing the
    JAX package. A `PersistentModelManifest` may name the user's own
    module (its model saved itself outside the blob), but not one of
    the JAX package. The loader keeps foreign code out; it is no
    sandbox, since a class of the port is built as the blob says, so a
    blob is trusted as far as its store is.
"""

from __future__ import annotations

import importlib
import io
import pickle
from dataclasses import dataclass
from typing import Any, List, Sequence

import numpy as np
import torch


@dataclass(frozen=True)
class PersistentModelManifest:
    """Stored instead of the model bytes (PersistentModelManifest.scala)."""
    class_module: str
    class_name: str


@dataclass(frozen=True)
class RetrainMarker:
    """Stored for `persist_model = False` algorithms: deploy retrains
    (the reference's `Unit` model, Engine.scala:286-304)."""


class PersistentModel:
    """Custom save/load (PersistentModel.scala:30-115). Implementors
    define `save(instance_id, params, ctx) -> bool` (False: store the
    model in the blob after all) and the classmethod
    `load(instance_id, params, ctx) -> model`."""

    def save(self, instance_id: str, params, ctx) -> bool:
        raise NotImplementedError

    @classmethod
    def load(cls, instance_id: str, params, ctx):
        raise NotImplementedError


class ForeignModelError(pickle.UnpicklingError):
    """A blob names a class outside what the port may load."""


def _tensor(array: np.ndarray, dtype: str) -> torch.Tensor:
    """A CPU tensor from its pickled numpy form (which pickle protocol 5
    may hand back read-only over the blob's bytes: copied then)."""
    return torch.from_numpy(np.require(array, requirements="W")).to(
        getattr(torch, dtype))


class _TorchAwarePickler(pickle.Pickler):
    """Pickles tensors as numpy arrays (bf16 through float32, which
    holds every bf16 value exactly)."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            t = obj.detach().cpu()
            dtype = str(t.dtype).removeprefix("torch.")
            if t.dtype == torch.bfloat16:
                t = t.float()
            return _tensor, (t.numpy(), dtype)
        return NotImplemented


# everything else a blob may name, by module
_NUMPY_NAMES = {
    "numpy": {"dtype", "ndarray"},
    "numpy._core.multiarray": {"_reconstruct", "scalar"},
    "numpy.core.multiarray": {"_reconstruct", "scalar"},
    "numpy._core.numeric": {"_frombuffer"},
    "numpy.core.numeric": {"_frombuffer"},
}
_BUILTIN_TYPES = {"bytearray", "complex", "frozenset", "range", "set",
                  "slice"}


def _admitted(module: str, name: str) -> bool:
    if module.split(".", 1)[0] == "predictionio_tpu_torch":
        if (module, name) == (__name__, "_tensor"):
            return True
        if module.endswith(".__main__"):   # importing it runs a program
            return False
        obj = importlib.import_module(module)
        for part in name.split("."):
            obj = getattr(obj, part, None)
        return isinstance(obj, type)
    if module == "torch":
        return name in ("Size", "device") or isinstance(
            getattr(torch, name, None), torch.dtype)
    if module == "builtins":
        return name in _BUILTIN_TYPES
    return name in _NUMPY_NAMES.get(module, ())


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module.split(".", 1)[0] == "predictionio_tpu":
            raise ForeignModelError(
                f"the model blob names {module}.{name}: it was written by "
                "the JAX package (predictionio_tpu), which the port does "
                "not load; train this engine with predictionio_tpu_torch")
        if _admitted(module, name):
            return super().find_class(module, name)
        raise ForeignModelError(
            f"the model blob names {module}.{name}, which the port does "
            "not load (allowed: classes of predictionio_tpu_torch, numpy "
            "arrays, torch sizes, devices and dtypes, builtin "
            "containers)")


def dumps(obj: Any) -> bytes:
    buf = io.BytesIO()
    _TorchAwarePickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def loads(data: bytes) -> Any:
    return _RestrictedUnpickler(io.BytesIO(data)).load()


def serialize_models(instance_id: str, algorithms: Sequence,
                     models: Sequence, ctx) -> bytes:
    """Decide each algorithm's persistence and make the instance blob
    (Engine.makeSerializableModels, Engine.scala:286-304)."""
    entries: List[Any] = []
    for algo, model in zip(algorithms, models):
        if isinstance(model, PersistentModel):
            if model.save(instance_id, algo.params, ctx):
                cls = type(model)
                entries.append(PersistentModelManifest(
                    cls.__module__, cls.__qualname__))
            else:
                entries.append(model)
        elif not getattr(algo, "persist_model", True):
            entries.append(RetrainMarker())
        else:
            entries.append(model)
    return dumps(entries)


def deserialize_models(blob: bytes, instance_id: str, algorithms: Sequence,
                       ctx, retrain) -> List[Any]:
    """Invert `serialize_models` at deploy (Engine.prepareDeploy,
    Engine.scala:199-269). `retrain(indices) -> {index: model}` runs
    only for the positions that hold a `RetrainMarker`."""
    entries = loads(blob)
    marker_ix = [i for i, e in enumerate(entries)
                 if isinstance(e, RetrainMarker)]
    fresh: dict = retrain(marker_ix) if marker_ix else {}
    out: List[Any] = []
    for i, (entry, algo) in enumerate(zip(entries, algorithms)):
        if isinstance(entry, PersistentModelManifest):
            if entry.class_module.split(".", 1)[0] == "predictionio_tpu":
                raise ForeignModelError(
                    f"the manifest names {entry.class_module}, a module of "
                    "the JAX package, which the port does not load")
            cls = importlib.import_module(entry.class_module)
            for part in entry.class_name.split("."):
                cls = getattr(cls, part)
            out.append(cls.load(instance_id, algo.params, ctx))
        elif isinstance(entry, RetrainMarker):
            out.append(fresh[i])
        else:
            out.append(entry)
    return out
