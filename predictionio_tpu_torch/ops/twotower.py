"""Two-tower neural retrieval: embedding towers trained with in-batch
sampled softmax.

The port of `predictionio_tpu/ops/twotower.py` (BASELINE.md config 5).
Each tower is `relu(table[ix] @ w1) @ w2`, divided by (its norm +
1e-8); the loss is the in-batch log-softmax of (u @ v^T) / temperature
over rows, with the diagonal as the labels. The parameters keep the JAX
package's names and its [fan_in, fan_out] layout (`x @ W`), as
`nn.Parameter`s of `TwoTowerNet`, so that `params_from_jax` is a checked
copy and a model's `params` resume a later run (`init_params`, the
streaming warm start).

`twotower_train` runs on `device` (None = cuda; raises without CUDA
unless `device="cpu"`): the gradient by autograd (the embedding
gradients are dense, as in JAX: no sparse rows) and `ops.adam.Adam`, one
eager step per batch, where the JAX package scans an epoch in one
program. The batch order is the JAX package's,
`np.random.RandomState(seed).permutation(n)[:m]` once per epoch, so the
two packages see the same batches. The initialization draws from a
`torch.Generator` seeded by `seed` on the CPU, not from threefry: from
the same seed the trained weights differ from the JAX package's, and
from the same `init_params` they agree to float association. After
training both towers are materialized over every id, in host RAM.

Over a mesh (`twotower_train(mesh=)`, the JAX package's shardings) the
towers are `ShardedTwoTowerNet`: over "model" the tables are
row-sharded (vocabulary blocks: each shard looks up the ids of its
range and the shards' lookups sum), `*_w1` column-sharded and `*_w2`
row-sharded (the shards' partial outputs sum); over "data" each step's
batch splits into one block per data shard, whose towers run on that
shard's devices; the towers' rows gather onto this process's first
device (and over processes, `parallel.gather_rows`) for the in-batch
loss. Each model shard of a parameter is held once per process and
moves to each data shard's device with `.to`, so autograd sums the data
shards' gradients; across processes they `all_reduce`. A batch whose
length does not divide over "data" runs unsplit on the first data
shard, as the JAX package's `len(sel) % data_size` test leaves it.
`ops.adam.Adam` updates every shard. `numpy_params` reassembles the
full tables, so the model pickles and serves as one trained on one
device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops.adam import Adam
from predictionio_tpu_torch.parallel.mesh import (all_reduce, gather_rows,
                                                  pad_to_multiple, spans,
                                                  split_over_data)

PARAM_NAMES = ("user_table", "item_table", "user_w1", "user_w2",
               "item_w1", "item_w2")


@dataclass
class TwoTowerModel:
    user_emb: np.ndarray    # [n_users, out_dim] final tower outputs
    item_emb: np.ndarray    # [n_items, out_dim]
    # the raw weights by JAX name, for a warm-start fold (None on
    # artifacts without them: those rebuild in full)
    params: Optional[Dict[str, np.ndarray]] = None

    def sanity_check(self):
        assert np.isfinite(self.user_emb).all()
        assert np.isfinite(self.item_emb).all()


def params_from_jax(params_np: Dict[str, np.ndarray]
                    ) -> Dict[str, np.ndarray]:
    """The JAX package's two-tower parameters (its flat dict, as numpy)
    as the port's: the same names and layout, float32 copies, checked."""
    missing = set(PARAM_NAMES) - set(params_np)
    extra = set(params_np) - set(PARAM_NAMES)
    if missing or extra:
        raise ValueError(f"two-tower params: missing {sorted(missing)}, "
                         f"unexpected {sorted(extra)}")
    out = {k: np.array(params_np[k], dtype=np.float32) for k in PARAM_NAMES}
    for side in ("user", "item"):
        t, w1, w2 = (out[f"{side}_table"], out[f"{side}_w1"],
                     out[f"{side}_w2"])
        if not (t.ndim == w1.ndim == w2.ndim == 2
                and t.shape[1] == w1.shape[0] and w1.shape[1] == w2.shape[0]):
            raise ValueError(f"two-tower params: {side} shapes {t.shape}, "
                             f"{w1.shape}, {w2.shape} do not chain")
    if out["user_w2"].shape[1] != out["item_w2"].shape[1]:
        raise ValueError("two-tower params: the towers' output widths "
                         "differ")
    return out


def random_params(seed: int, n_users: int, n_items: int, emb_dim: int,
                  hidden: int, out_dim: int) -> Dict[str, np.ndarray]:
    """Random weights from a CPU `torch.Generator` seeded by `seed`, in
    the JAX package's scales: tables normal / sqrt(emb_dim), dense
    layers normal / sqrt(fan_in)."""
    gen = torch.Generator().manual_seed(int(seed))

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32)

    def dense(fan_in, fan_out):
        return normal(fan_in, fan_out) / np.sqrt(fan_in)

    scale = 1.0 / np.sqrt(emb_dim)
    p = {"user_table": normal(n_users, emb_dim) * scale,
         "item_table": normal(n_items, emb_dim) * scale,
         "user_w1": dense(emb_dim, hidden), "user_w2": dense(hidden, out_dim),
         "item_w1": dense(emb_dim, hidden), "item_w2": dense(hidden, out_dim)}
    return {k: v.numpy() for k, v in p.items()}


class TwoTowerNet(nn.Module):
    """The two towers' weights as parameters named as in the JAX pytree."""

    def __init__(self, params: Dict[str, np.ndarray], device=None):
        super().__init__()
        dev = resolve_device(device)
        for name in PARAM_NAMES:
            setattr(self, name, nn.Parameter(torch.as_tensor(
                np.asarray(params[name], np.float32)).to(dev)))

    def tower(self, side: str, ix: torch.Tensor) -> torch.Tensor:
        """[b] ids -> [b, out_dim] unit rows (norm + 1e-8, not clamped)."""
        table = getattr(self, f"{side}_table")
        h = torch.relu(table[ix] @ getattr(self, f"{side}_w1"))
        out = h @ getattr(self, f"{side}_w2")
        return out / (torch.linalg.vector_norm(out, dim=-1, keepdim=True)
                      + 1e-8)

    def loss(self, u_ix: torch.Tensor, i_ix: torch.Tensor,
             temperature: float) -> torch.Tensor:
        """In-batch sampled softmax: each (u, i) pair takes the batch's
        other items as negatives."""
        return _in_batch_loss(self.tower("user", u_ix),
                              self.tower("item", i_ix), temperature)

    def numpy_params(self) -> Dict[str, np.ndarray]:
        return {name: getattr(self, name).detach().cpu().numpy()
                for name in PARAM_NAMES}


def _in_batch_loss(u: torch.Tensor, v: torch.Tensor,
                   temperature: float) -> torch.Tensor:
    logits = (u @ v.T) / temperature                      # [b, b]
    return -torch.log_softmax(logits, dim=1).diagonal().mean()


class ShardedTwoTowerNet:
    """The two towers over the "data" x "model" plane of a mesh (see the
    module docstring). `shards[name][m]` is model shard m of parameter
    `name`, an `nn.Parameter` on this process's first data shard's
    device of that model position; a table is padded with zero rows,
    and `*_w1` / `*_w2` with zero hidden units, to a multiple of the
    model shards (a padding row is never looked up and a padding unit
    stays 0 under Adam)."""

    def __init__(self, params: Dict[str, np.ndarray], mesh):
        mesh.require_local("model")
        self.mesh = mesh
        self.data = mesh.along("data")
        plane = mesh.plane("data", "model")
        self.devs = [[mesh.devices[int(p)] for p in plane[s]]
                     for s in self.data.local]
        m = plane.shape[1]
        self.widths = {k: v.shape for k, v in params.items()}
        hidden = params["user_w1"].shape[1]
        hp = pad_to_multiple(hidden, m)
        self.rows = {}
        self.shards: Dict[str, List[nn.Parameter]] = {}
        for name, a in params.items():
            a = np.asarray(a, np.float32)
            if name.endswith("_table"):
                self.rows[name] = pad_to_multiple(a.shape[0], m) // m
                a = np.pad(a, ((0, self.rows[name] * m - a.shape[0]), (0, 0)))
                parts = np.split(a, m, axis=0)
            elif name.endswith("_w1"):
                parts = np.split(np.pad(a, ((0, 0), (0, hp - hidden))), m,
                                 axis=1)
            else:
                parts = np.split(np.pad(a, ((0, hp - hidden), (0, 0))), m,
                                 axis=0)
            self.shards[name] = [nn.Parameter(torch.from_numpy(
                np.ascontiguousarray(part)).to(dev))
                for part, dev in zip(parts, self.devs[0])]

    def parameters(self) -> List[nn.Parameter]:
        return [p for name in PARAM_NAMES for p in self.shards[name]]

    def tower(self, side: str, ix: torch.Tensor, shard: int = 0
              ) -> torch.Tensor:
        """`TwoTowerNet.tower` on local data shard `shard`'s devices;
        the result on its first device."""
        devs = self.devs[shard]
        root = devs[0]
        name = f"{side}_table"
        rows = self.rows[name]
        emb = None
        for m, dev in enumerate(devs):
            local = ix.to(dev) - m * rows
            hit = (local >= 0) & (local < rows)
            e = (self.shards[name][m].to(dev)[local.clamp(0, rows - 1)]
                 * hit[:, None]).to(root)
            emb = e if emb is None else emb + e
        out = None
        for m, dev in enumerate(devs):
            h = torch.relu(emb.to(dev)
                           @ self.shards[f"{side}_w1"][m].to(dev))
            o = (h @ self.shards[f"{side}_w2"][m].to(dev)).to(root)
            out = o if out is None else out + o
        return out / (torch.linalg.vector_norm(out, dim=-1, keepdim=True)
                      + 1e-8)

    def loss(self, u_ix: torch.Tensor, i_ix: torch.Tensor,
             temperature: float) -> torch.Tensor:
        """`TwoTowerNet.loss` on this process's first device, the batch
        split over "data" where `split_over_data` says so."""
        if not split_over_data(self.mesh, len(u_ix)):
            return _in_batch_loss(self.tower("user", u_ix),
                                  self.tower("item", i_ix), temperature)
        root = self.devs[0][0]
        b = len(u_ix) // self.data.size
        us, vs = [], []
        for j, s in enumerate(self.data.local):
            rows = slice(s * b, (s + 1) * b)
            us.append(self.tower("user", u_ix[rows], j).to(root))
            vs.append(self.tower("item", i_ix[rows], j).to(root))
        u = gather_rows(torch.cat(us), self.data)
        v = gather_rows(torch.cat(vs), self.data)
        return _in_batch_loss(u, v, temperature)

    def numpy_params(self) -> Dict[str, np.ndarray]:
        out = {}
        for name, (n, w) in self.widths.items():
            parts = [p.detach().cpu().numpy() for p in self.shards[name]]
            axis = 1 if name.endswith("_w1") else 0
            full = np.concatenate(parts, axis=axis)
            out[name] = full[:, :w] if axis else full[:n]
        return out


def train_step(net, adam: Adam, u_ix: torch.Tensor, i_ix: torch.Tensor,
               temperature: float) -> torch.Tensor:
    """One batch: the loss, its gradients by autograd, one Adam update.
    Returns the loss (a 0-dim device tensor; nothing waits for it). On a
    `ShardedTwoTowerNet` the gradients of a split batch sum over
    processes first."""
    loss = net.loss(u_ix, i_ix, temperature)
    grads = torch.autograd.grad(loss, adam.params)
    mesh = getattr(net, "mesh", None)
    if split_over_data(mesh, len(u_ix)):
        grads = [all_reduce(g, mesh) for g in grads]
    adam.step(grads)
    return loss.detach()


def twotower_train(u_ix: np.ndarray, i_ix: np.ndarray, *,
                   n_users: int, n_items: int,
                   emb_dim: int = 32, hidden: int = 64, out_dim: int = 32,
                   batch_size: int = 1024, epochs: int = 10,
                   lr: float = 1e-2, temperature: float = 0.1,
                   seed: int = 0, device=None, mesh=None,
                   init_params: Optional[dict] = None,
                   step_losses: Optional[List[torch.Tensor]] = None,
                   on_step: Optional[Callable[[int], None]] = None
                   ) -> TwoTowerModel:
    """Train on interaction pairs; returns the materialized towers.

    `mesh` (a `parallel.Mesh` with a "data" or "model" axis of size > 1)
    trains `ShardedTwoTowerNet` over it, the towers materialized on its
    first local device (a mesh without such an axis trains there as on
    one device); None trains on `device`. `init_params` (JAX
    names and layout) resumes from earlier weights, with fresh Adam
    moments, so that one epoch from converged weights moves them only
    slightly. `step_losses`, if given, gets each step's loss as a device
    tensor; `on_step`, if given, is called with each step's index (from
    0 over all epochs) once the step is enqueued."""
    dev = resolve_device(device if mesh is None else mesh.local_devices[0])
    mesh = mesh if spans(mesh, "data", "model") else None
    n = len(u_ix)
    if n == 0:
        raise ValueError("no interaction pairs")
    batch_size = min(batch_size, n)
    if init_params is not None:
        params = params_from_jax(init_params)
    else:
        params = random_params(seed, n_users, n_items, emb_dim, hidden,
                               out_dim)
    net = (TwoTowerNet(params, dev) if mesh is None
           else ShardedTwoTowerNet(params, mesh))
    adam = Adam(list(net.parameters()), lr)
    rng = np.random.RandomState(seed)
    steps = max(n // batch_size, 1)
    m = steps * batch_size
    u_ix, i_ix = np.asarray(u_ix), np.asarray(i_ix)
    from predictionio_tpu_torch.resilience.watchdog import progress
    for epoch in range(epochs):
        progress()          # an epoch of a refresher's rebuild stamps it
        order = rng.permutation(n)[:m]
        ub_all = torch.from_numpy(
            u_ix[order].astype(np.int64).reshape(steps, batch_size)).to(dev)
        ib_all = torch.from_numpy(
            i_ix[order].astype(np.int64).reshape(steps, batch_size)).to(dev)
        for s in range(steps):
            loss = train_step(net, adam, ub_all[s], ib_all[s], temperature)
            if step_losses is not None:
                step_losses.append(loss)
            if on_step is not None:
                on_step(epoch * steps + s)
    if mesh is not None:
        net = TwoTowerNet(net.numpy_params(), dev)
    with torch.no_grad():
        user_emb = net.tower("user", torch.arange(n_users, device=dev))
        item_emb = net.tower("item", torch.arange(n_items, device=dev))
    return TwoTowerModel(user_emb.cpu().numpy(), item_emb.cpu().numpy(),
                         params=net.numpy_params())
