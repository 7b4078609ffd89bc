"""Device meshes, row sharding and multi-process setup.

The port of `predictionio_tpu/parallel/mesh.py` (Runner.scala's
spark-submit topology, SURVEY.md §2.8). A `MeshSpec` is carried in the
engine instance's `runtime_conf` (the slot the reference used for
`sparkConf`), so training and serving agree on the device layout.

  - `MeshSpec` is a copy of the JAX package's.
  - `make_mesh` returns a `Mesh`: the axis names and sizes and a
    row-major tuple of torch devices, every process's, with this
    process's index and count. The JAX package returns a
    `jax.sharding.Mesh`; torch has no global device, so the entries of
    another process are its own local devices, in process order, as
    `jax.devices()` lists them. A list may name one device more than
    once: several shards on one card (or on the CPU).
  - `initialize_distributed` joins a `torch.distributed` process group
    where the JAX package joins `jax.distributed`.
  - `pad_to_multiple` and `pad_rows` are copies; `shard_put` is the row
    sharding that `jax.device_put` with a batch sharding gives there,
    written out as one contiguous tensor per device. `batch_sharding`
    and `replicated_sharding` are `jax.sharding` objects with no
    counterpart: the port's sharded code holds a list of per-shard
    tensors and moves them itself.
  - A trainer addresses one axis through the `Mesh`: `groups(axis)`
    (the positions that vary only along it), `local_part` (this
    process's part of a group), `plane(*axes)` (the positions over
    some axes at coordinate 0 of the others) and `along(axis)` (the
    one-axis mesh of a program replicated over the other axes). Inside
    a process a shard's tensors move with `.to(device)`, a no-op where
    shards share a card, and autograd carries gradients through it.
    Across processes only "data" may span (`require_local`): its sums
    go through `all_reduce`, and `gather_rows` collects the rows of a
    batch for a loss that every process computes whole.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class MeshSpec:
    """A declarative mesh shape: axis name -> size; -1 means 'all remaining
    devices'. The default is pure data parallelism over every device, the
    analog of Spark defaulting to one partition per core."""
    axes: Mapping[str, int] = field(default_factory=lambda: {"data": -1})

    def resolve(self, n_devices: int) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
        names = tuple(self.axes.keys())
        sizes = list(self.axes.values())
        wild = [i for i, s in enumerate(sizes) if s == -1]
        if len(wild) > 1:
            raise ValueError("At most one mesh axis may be -1")
        fixed = int(np.prod([s for s in sizes if s != -1])) if sizes else 1
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {fixed}")
            sizes[wild[0]] = n_devices // fixed
        total = int(np.prod(sizes)) if sizes else 1
        if total > n_devices:
            raise ValueError(
                f"Mesh {dict(zip(names, sizes))} needs {total} devices, "
                f"have {n_devices}")
        return names, tuple(int(s) for s in sizes)

    @staticmethod
    def from_conf(conf: Mapping[str, str]) -> "MeshSpec":
        """Parse 'mesh' key of runtime_conf, e.g. 'data=8' or
        'data=4,model=2'. Missing/empty -> default all-data mesh."""
        s = (conf or {}).get("mesh", "")
        if not s:
            return MeshSpec()
        axes = {}
        for part in s.split(","):
            k, _, v = part.partition("=")
            axes[k.strip()] = int(v)
        return MeshSpec(axes)


@dataclass(frozen=True)
class Mesh:
    """A device mesh: `devices` row-major over `axis_names` x `sizes`,
    every process's entries in process order, each process holding an
    equal, contiguous run of them."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...]
    process_index: int = 0
    process_count: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as `jax.sharding.Mesh.shape`."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local(self) -> Tuple[int, ...]:
        """Positions in `devices` of this process's entries."""
        per = self.size // self.process_count
        return tuple(range(self.process_index * per,
                           (self.process_index + 1) * per))

    @property
    def local_devices(self) -> Tuple[torch.device, ...]:
        return tuple(self.devices[s] for s in self.local)

    def owner(self, pos: int) -> int:
        """The process that holds mesh position `pos`."""
        return pos // (self.size // self.process_count)

    def plane(self, *axes: str) -> np.ndarray:
        """Positions (flat indices into `devices`) over `axes`, in that
        order, at coordinate 0 of every other axis: an int array of
        shape [size of each axis]; an axis the mesh lacks has size 1."""
        grid = np.arange(self.size).reshape(self.sizes)
        grid = grid[tuple(slice(None) if a in axes else 0
                          for a in self.axis_names)]
        kept = [a for a in self.axis_names if a in axes]
        grid = np.transpose(grid, [kept.index(a) for a in axes if a in kept])
        return grid.reshape([self.shape.get(a, 1) for a in axes])

    def groups(self, axis: str) -> List[Tuple[int, ...]]:
        """The groups of positions that vary only along `axis`, one per
        setting of the other axes in row-major order, each in `axis`
        order (one group per position when the mesh lacks `axis`)."""
        grid = np.arange(self.size).reshape(self.sizes)
        if axis not in self.axis_names:
            return [(int(p),) for p in grid.ravel()]
        grid = np.moveaxis(grid, self.axis_names.index(axis), -1)
        return [tuple(int(p) for p in g)
                for g in grid.reshape(-1, self.shape[axis])]

    def local_part(self, group: Sequence[int]) -> Tuple[int, ...]:
        """The positions of `group` that this process holds."""
        return tuple(p for p in group if self.owner(p) == self.process_index)

    def axis_is_local(self, axis: str) -> bool:
        """True when every group along `axis` lies inside one process:
        its shards exchange tensors with `.to(device)`, never over
        `torch.distributed`."""
        return all(len({self.owner(p) for p in g}) == 1
                   for g in self.groups(axis))

    def require_local(self, *axes: str) -> None:
        """Raise NotImplementedError when one of `axes` spans processes.
        Only "data" may: its partial sums and gradients reduce with
        `torch.distributed.all_reduce`; a "model" or "sp" axis across
        processes needs a ppermute over `torch.distributed` (ROADMAP
        Queue 1, item 6(e))."""
        for axis in axes:
            if self.shape.get(axis, 1) > 1 and not self.axis_is_local(axis):
                raise NotImplementedError(
                    f"the {axis!r} axis of mesh {self.shape} spans "
                    f"{self.process_count} processes; only 'data' may "
                    "span processes (split the mesh over 'data', with "
                    f"every {axis!r} group inside one process)")

    def along(self, axis: str = "data") -> "Mesh":
        """The one-axis mesh over `axis` at coordinate 0 of every other
        axis: the shards of a program that runs over `axis` alone and
        is the same on every position of the others (each data group
        is computed once and stands for its replicas). Its processes
        hold equal, contiguous runs, as every `Mesh`'s do; raises
        NotImplementedError when another axis spans processes or the
        processes do not split `axis` so."""
        self.require_local(*(a for a in self.axis_names if a != axis))
        group = [int(p) for p in self.plane(axis).ravel()]
        owners = [self.owner(p) for p in group]
        per = len(group) // self.process_count
        if not per or owners != [i // per for i in range(len(group))]:
            raise NotImplementedError(
                f"mesh {self.shape} over {self.process_count} processes: "
                f"each process must hold an equal, contiguous run of "
                f"{axis!r}")
        return Mesh((axis,), (len(group),),
                    tuple(self.devices[p] for p in group),
                    self.process_index, self.process_count)


def local_devices(device=None) -> List[torch.device]:
    """This process's devices of `device`'s kind: every CUDA card for a
    CUDA device (None = cuda; raises without CUDA), else `device`
    repeated `PIO_CPU_DEVICE_COUNT` times (default 1), the counterpart
    of XLA's `--xla_force_host_platform_device_count`."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev] * int(os.environ.get("PIO_CPU_DEVICE_COUNT", "1") or 1)


def make_mesh(spec: Optional[MeshSpec] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A `Mesh` of `spec` (None = all-data) over this process's
    `devices` (None = `local_devices()`: every CUDA card, raising
    without CUDA) and, in a `torch.distributed` group, over every
    process's: the global list is each process's list in process order,
    every process giving as many devices as this one.

    Uses only the largest prefix of the devices that fills the mesh
    shape (so a 7-device pool with data=-1 uses all 7; data=4 uses the
    first 4); a shape past the devices given raises. Across processes
    the mesh must split evenly, and each process gives its first
    size / n_processes devices."""
    local = [torch.device(d) for d in (
        devices if devices is not None else local_devices())]
    pid, n_proc = 0, 1
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        pid = torch.distributed.get_rank()
        n_proc = torch.distributed.get_world_size()
    spec = spec or MeshSpec()
    names, sizes = spec.resolve(len(local) * n_proc)
    n = int(np.prod(sizes)) if sizes else 1
    if n % n_proc:
        raise ValueError(f"mesh {dict(zip(names, sizes))} of {n} devices "
                         f"does not split evenly over {n_proc} processes")
    per = n // n_proc
    return Mesh(names, sizes, tuple(local[:per]) * n_proc, pid, n_proc)


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= n (>= m so empty stays shardable)."""
    return max(((n + m - 1) // m) * m, m)


def pad_rows(a: np.ndarray, target: int, fill=0) -> np.ndarray:
    """Pad dim 0 of `a` to `target` rows with `fill`."""
    if a.shape[0] == target:
        return a
    if a.shape[0] > target:
        raise ValueError(f"Cannot pad {a.shape[0]} rows down to {target}")
    pad_width = [(0, target - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad_width, constant_values=fill)


def shard_put(host: np.ndarray, devices, *,
              dtype=np.float32) -> List[torch.Tensor]:
    """Pad dim 0 of `host` with zero rows to a multiple of the shard
    count and place block s of the rows on shard s's device: one
    contiguous tensor of `per_shard` rows per shard, in `dtype` (None
    keeps `host`'s), never sharing memory with `host`. `devices` is a
    device list (every shard is here) or a one-axis `Mesh`, whose rows
    split over all its shards and of which this process places its own
    (`mesh.local`)."""
    if isinstance(devices, Mesh):
        n, mine = devices.size, list(zip(devices.local,
                                         devices.local_devices))
    else:
        n, mine = len(devices), list(enumerate(devices))
    if not n:
        raise ValueError("shard_put: no devices")
    a = np.ascontiguousarray(host, dtype=dtype)
    a = pad_rows(a, pad_to_multiple(a.shape[0], n))
    per = a.shape[0] // n
    return [torch.tensor(a[s * per:(s + 1) * per], device=dev)
            for s, dev in mine]


def spans(mesh, *axes: str) -> bool:
    """True when `mesh` (None = no mesh) has one of `axes` at a size
    above 1: a trainer then takes its mesh form, else it trains on its
    `device` as without a mesh (the JAX package runs its sharded
    program over one device there)."""
    return mesh is not None and any(mesh.shape.get(a, 1) > 1 for a in axes)


def data_mesh(mesh, device) -> Mesh:
    """The one-axis "data" mesh that a sample-sharded trainer runs over:
    `mesh.along("data")` when `mesh` has a "data" axis of size > 1, else
    one shard on `device` (one device's training, no padding and no
    reduction)."""
    if spans(mesh, "data"):
        return mesh.along("data")
    return Mesh(("data",), (1,), (torch.device(device),))


def split_over_data(mesh, batch: int) -> bool:
    """True when a batch of `batch` rows splits over the "data" axis of
    `mesh` (size > 1, dividing it), as the JAX package's trainers shard
    it; else it runs unsplit."""
    n = mesh.shape.get("data", 1) if mesh is not None else 1
    return n > 1 and batch % n == 0


def all_reduce(t: torch.Tensor, mesh) -> torch.Tensor:
    """`t` summed in place over the processes of `mesh` (a no-op in one
    process): the `psum` of a "data" axis that spans processes."""
    if mesh.process_count > 1:
        torch.distributed.all_reduce(t)
    return t


class _GatherRows(torch.autograd.Function):
    """Every process's rows of a tensor, in process order. Its backward
    keeps this process's rows of the incoming gradient and sends
    nothing: every process runs the same computation on the gathered
    tensor, so each already holds the whole gradient."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, n_proc: int, rank: int):
        ctx.rows, ctx.rank = t.shape[0], rank
        t = t.contiguous()
        full = t.new_empty((t.shape[0] * n_proc,) + tuple(t.shape[1:]))
        torch.distributed.all_gather_into_tensor(full, t)
        return full

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        lo = ctx.rank * ctx.rows
        return grad[lo:lo + ctx.rows], None, None


def gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """The rows of `t` from every process of `mesh`, in process order
    (`t` itself in one process), differentiable when every process
    computes the same function of the result (`_GatherRows`)."""
    if mesh.process_count == 1:
        return t
    return _GatherRows.apply(t, mesh.process_count, mesh.process_index)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device=None) -> bool:
    """Join a `torch.distributed` process group for multi-process
    training; no-op (False) when no coordinator is configured. Explicit
    arguments override the PIO_TPU_COORDINATOR / _NUM_PROCESSES /
    _PROCESS_ID env vars; `coordinator` is the host:port of process 0,
    the group's `tcp://` rendezvous. The backend is `nccl` for a CUDA
    `device` (None = cuda) and `gloo` for the CPU. Idempotent: a call in
    a process already in a group returns True without joining again.
    Nothing is written to `os.environ`. The analog of the reference
    forwarding PIO_* env through spark-submit to Spark's driver and
    executors (`Runner.scala:213-215,298-305`)."""
    addr = coordinator or os.environ.get("PIO_TPU_COORDINATOR")
    if not addr:
        return False
    if torch.distributed.is_initialized():
        return True

    def setting(explicit, env_key, what):
        if explicit is not None:
            return int(explicit)
        val = os.environ.get(env_key)
        if val is None:
            raise ValueError(
                f"Multi-process init needs {what}: pass it explicitly "
                f"(--num-processes/--process-id) or set {env_key}")
        return int(val)

    n_proc = setting(num_processes, "PIO_TPU_NUM_PROCESSES",
                     "the process count")
    pid = setting(process_id, "PIO_TPU_PROCESS_ID", "this process's id")
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{addr}", world_size=n_proc, rank=pid)
    return True
