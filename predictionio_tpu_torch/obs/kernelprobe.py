"""Kernel build and launch probe: the port's counterpart of the JAX
package's `obs/jaxprobe.py`.

The JAX package counts XLA backend compilations, its jit cache misses.
The port compiles nothing per shape: its one cost of that kind is the
nvcc build of `csrc/fused_topk.cu` into `_build/` at a process's first
use, when no library of the source's hash is there yet
(`ops.fused_topk.build_library`). So the probe counts

  - `pio_kernel_builds_total` and `pio_kernel_build_seconds`: nvcc
    builds, recorded by `build_library` through `record_build`;
  - `pio_kernel_launches_total{kernel}`: the wrappers' own launch
    counts (`ops.fused_topk.LAUNCHES` as kernel="fused_topk",
    `SHARD_LAUNCHES` as kernel="shard_local_candidates"), read at
    scrape time by `sync_launches`, one of every server's tsdb
    collectors and run on each `/metrics`.

`build_count()` and `build_watch()` replace `compile_count` and
`compile_watch`: `cli train` reports a run's builds as `kernelBuilds`
where the JAX report has `jaxCompiles`, and a steady-state serve must
build nothing. `install_kernel_probe(registry)` adds a registry to the
ones builds are recorded into (the process-default registry always is);
it is idempotent.
"""

from __future__ import annotations

import sys
import threading
import weakref
from contextlib import contextmanager
from typing import Optional

from predictionio_tpu_torch.obs.metrics import (MetricsRegistry,
                                                get_registry)

BUILD_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 20.0, 30.0, 60.0, 120.0, 300.0)
# the wrappers' launch counters, by the `kernel` label they carry
KERNEL_COUNTERS = (("fused_topk", "LAUNCHES"),
                   ("shard_local_candidates", "SHARD_LAUNCHES"))

_lock = threading.Lock()
_registries: "weakref.WeakSet" = weakref.WeakSet()
# per registry: the wrapper counts last written into it
_launch_seen: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _instruments(registry: MetricsRegistry):
    counter = registry.counter(
        "pio_kernel_builds_total",
        "nvcc builds of the port's CUDA kernels (a process's first use "
        "of a source with no library built)")
    hist = registry.histogram(
        "pio_kernel_build_seconds", "nvcc wall time per kernel build",
        buckets=BUILD_BUCKETS)
    return counter, hist


def install_kernel_probe(registry: Optional[MetricsRegistry] = None) -> None:
    """Record kernel builds into `registry` (default: the
    process-default registry) from now on; idempotent."""
    reg = registry if registry is not None else get_registry()
    _instruments(reg)
    with _lock:
        _registries.add(reg)


def record_build(seconds: float) -> None:
    """One nvcc build of `seconds`, into every installed registry (the
    process-default one at least)."""
    install_kernel_probe()
    with _lock:
        regs = list(_registries)
    for reg in regs:
        counter, hist = _instruments(reg)
        counter.inc()
        hist.observe(seconds)


def build_count(registry: Optional[MetricsRegistry] = None) -> int:
    """Kernel builds recorded in this process (0 before any)."""
    counter, _ = _instruments(registry if registry is not None
                              else get_registry())
    return int(counter.value)


class _BuildWatch:
    """Result object of `build_watch`; `.count` is live inside the
    block and frozen at exit."""

    def __init__(self, registry: Optional[MetricsRegistry]):
        self._registry = registry
        self._before = build_count(registry)
        self._final: Optional[int] = None

    @property
    def count(self) -> int:
        if self._final is not None:
            return self._final
        return build_count(self._registry) - self._before


@contextmanager
def build_watch(registry: Optional[MetricsRegistry] = None):
    """Count kernel builds across a block::

        with build_watch() as w:
            serve_a_lot()
        assert w.count == 0   # steady state must not build

    Installs the probe on entry (idempotent)."""
    install_kernel_probe(registry)
    watch = _BuildWatch(registry)
    try:
        yield watch
    finally:
        watch._final = build_count(registry) - watch._before


def sync_launches(registry: Optional[MetricsRegistry] = None) -> None:
    """Advance `pio_kernel_launches_total{kernel}` in `registry` to the
    wrappers' counts. A process that never imported the kernel module
    (the event server, ingestd) has no launches and imports nothing
    here; a count set back (a test or a run resetting it to 0) restarts
    the delta from there."""
    reg = registry if registry is not None else get_registry()
    ft = sys.modules.get("predictionio_tpu_torch.ops.fused_topk")
    if ft is None:
        return
    fam = reg.counter("pio_kernel_launches_total",
                      "Launches of the port's CUDA kernels by wrapper",
                      labels=("kernel",))
    with _lock:
        seen = _launch_seen.setdefault(reg, {})
        for kernel, attr in KERNEL_COUNTERS:
            now = int(getattr(ft, attr, 0))
            delta = now - seen.get(kernel, 0)
            if delta < 0:
                # the wrapper's count was set back: all it counts now
                # are new launches
                delta = now
            if delta:
                fam.labels(kernel=kernel).inc(delta)
            seen[kernel] = now
