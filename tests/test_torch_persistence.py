"""The port's model blob (`core/persistence.py`): an `ALSModel` round
trip (CPU tensors stand in for the card's; the loaded model lands on
the device asked for), bf16 tensors, the `RetrainMarker` and
`PersistentModelManifest` paths, and the refusal of a blob that names
the JAX package, which a CPU process without `predictionio_tpu`
loaded shows without importing it."""

import pickle
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu.core import persistence as jpers
from predictionio_tpu.ingest import BiMap as JBiMap
from predictionio_tpu.ops import als as jals
from predictionio_tpu_torch.core import persistence as pers
from predictionio_tpu_torch.ingest.bimap import BiMap
from predictionio_tpu_torch.ops.als import ALSModel

pytestmark = pytest.mark.torch

REPO = Path(__file__).resolve().parents[1]


def _model(seed=0):
    g = torch.Generator().manual_seed(seed)
    return ALSModel(torch.randn(7, 4, generator=g),
                    torch.randn(9, 4, generator=g),
                    BiMap.from_keys(f"u{n}" for n in range(7)),
                    BiMap.from_keys(f"i{n}" for n in range(9)))


@dataclass
class _Algo:
    params: object = None
    persist_model: bool = True


def test_als_model_round_trip_lands_on_the_device_asked_for():
    m = _model()
    m.users.inverse(3)   # a filled inverse cache travels too
    blob = pers.serialize_models("iid", [_Algo()], [m], ctx=None)
    back, = pers.deserialize_models(blob, "iid", [_Algo()], None,
                                    retrain=None)
    assert isinstance(back, ALSModel)
    assert back.user_factors.device.type == "cpu"
    assert torch.equal(back.user_factors, m.user_factors)
    assert torch.equal(back.item_factors, m.item_factors)
    assert back.users == m.users and back.items == m.items
    placed = back.to("cpu", items_device="cpu")
    placed.sanity_check()
    assert placed.device == torch.device("cpu")
    assert placed.users is back.users
    back.user_factors[0, 0] = 1.0          # a writable copy of the blob


def test_tensors_pickle_as_numpy_whatever_their_dtype():
    obj = {"bf16": torch.tensor([1.5, -2.25]).bfloat16(),
           "i64": torch.arange(5), "bool": torch.tensor([True, False]),
           "view": torch.arange(12.0).reshape(3, 4)[:, 1]}
    blob = pers.dumps(obj)
    assert b"torch._utils" not in blob        # no torch storage pickling
    back = pers.loads(blob)
    for k, v in obj.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_model_to_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _model().to()


def test_retrain_marker_retrains_only_those_positions():
    calls = []

    def retrain(ix):
        calls.append(ix)
        return {i: f"fresh{i}" for i in ix}

    algos = [_Algo(), _Algo(persist_model=False), _Algo()]
    blob = pers.serialize_models("iid", algos, [_model(), "dropped", "kept"],
                                 None)
    out = pers.deserialize_models(blob, "iid", algos, None, retrain)
    assert calls == [[1]] and out[1:] == ["fresh1", "kept"]
    assert isinstance(out[0], ALSModel)


class SavedElsewhere(pers.PersistentModel):
    store = {}

    def __init__(self, value):
        self.value = value

    def save(self, instance_id, params, ctx):
        if self.value is None:
            return False
        SavedElsewhere.store[instance_id] = (self.value, params)
        return True

    @classmethod
    def load(cls, instance_id, params, ctx):
        value, saved = cls.store[instance_id]
        assert saved == params
        return cls(value)


def test_persistent_model_manifest():
    blob = pers.serialize_models("iid", [_Algo(params="p")],
                                 [SavedElsewhere(42)], None)
    entries = pickle.loads(blob)
    assert entries == [pers.PersistentModelManifest(
        __name__, "SavedElsewhere")]
    back, = pers.deserialize_models(blob, "iid", [_Algo(params="p")], None,
                                    retrain=None)
    assert isinstance(back, SavedElsewhere) and back.value == 42
    jax_manifest = pers.dumps([pers.PersistentModelManifest(
        "predictionio_tpu.ops.als", "ALSModel")])
    with pytest.raises(pers.ForeignModelError, match="JAX package"):
        pers.deserialize_models(jax_manifest, "iid", [_Algo()], None, None)


def test_restricted_unpickler_refuses_foreign_classes():
    for obj in (print, subprocess.Popen, Path("x"), torch.load, np.load,
                np.memmap, pers.loads, getattr, type):
        with pytest.raises(pers.ForeignModelError):
            pers.loads(pickle.dumps(obj))
    with pytest.raises(pers.ForeignModelError):   # a GLOBAL opcode
        pers.loads(b"cpredictionio_tpu_torch.cli.__main__\nmain\n.")
    assert pers.loads(pickle.dumps({1: (2.0, "3", b"4", {5}, None)})) == {
        1: (2.0, "3", b"4", {5}, None)}


def test_blob_of_the_jax_package_is_refused(tmp_path):
    """An instance the JAX package trained into a shared store: the
    port refuses its blob with a clear error, and in a process where
    the JAX package is not loaded it stays unloaded."""
    jmodel = jals.ALSModel(np.ones((2, 3), np.float32),
                           np.ones((4, 3), np.float32),
                           JBiMap.from_keys(["a", "b"]),
                           JBiMap.from_keys(["w", "x", "y", "z"]))
    blob = jpers.serialize_models("iid", [_Algo()], [jmodel], None)
    with pytest.raises(pers.ForeignModelError, match="predictionio_tpu"):
        pers.deserialize_models(blob, "iid", [_Algo()], None, None)
    path = tmp_path / "blob.bin"
    path.write_bytes(blob)
    code = (
        "import sys\n"
        "from predictionio_tpu_torch.core import persistence as p\n"
        f"blob = open({str(path)!r}, 'rb').read()\n"
        "try:\n"
        "    p.loads(blob)\n"
        "except p.ForeignModelError as e:\n"
        "    print('refused', 'JAX package' in str(e))\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'predictionio_tpu.'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["refused True", "[]"]
