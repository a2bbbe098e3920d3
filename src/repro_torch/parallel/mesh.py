"""Mesh and axis conventions over ``torch.distributed``: the JAX
package's ``parallel/mesh.py`` for explicit SPMD.

Axes:
  pod   -- data-parallel across hosts; gradient all-reduce only
  data  -- data-parallel inside a host (serving replicas, serve/cluster.py:
           one device row each, :func:`dp_submeshes`)
  model -- tensor parallel

The reference is single-controller: one program over a
``jax.sharding.Mesh`` of devices.  Here every rank is a process of its
own (:func:`spawn`), and a :class:`Mesh` is this rank's view of the
device grid: the axis names and sizes, its coordinates, and for each axis
wider than 1 the process group of the ranks it shares that axis row
with.  Model code names an axis (``ModelConfig.tp_axis``); the
collectives (parallel/collectives.py) find its group in the mesh made
active by :func:`use_mesh`, so no group object ever enters a config.
"""

from __future__ import annotations

import contextlib
import os
import queue
import shutil
import tempfile
import threading
import traceback
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np

BATCH_AXES: Tuple[str, ...] = ("pod", "data")
MODEL_AXIS = "model"
DATA_AXIS = "data"
POD_AXIS = "pod"


class Mesh:
    """This rank's view of an (axis -> size) device grid.  ``groups``
    maps each axis of size > 1 to the process group of this rank's row
    along it; ``backend`` is the process groups' ("gloo" / "nccl"; None
    on a one-rank mesh, which needs no process group)."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int],
                 rank: int = 0, groups: Optional[Dict[str, Any]] = None,
                 backend: Optional[str] = None):
        if len(axis_names) != len(shape):
            raise ValueError(f"axes {axis_names} vs shape {shape}")
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(s) for s in shape)
        self.rank = int(rank)
        self.groups = dict(groups or {})
        self.backend = backend

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def group(self, axis: str):
        """The process group spanning ``axis`` through this rank."""
        if axis not in self.groups:
            raise KeyError(f"mesh {self.sizes} has no group for axis "
                           f"{axis!r} (absent, or of size 1)")
        return self.groups[axis]

    def __repr__(self) -> str:
        return (f"Mesh({self.sizes}, rank={self.rank}, "
                f"backend={self.backend})")


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 1) -> Mesh:
    """A (data, model) mesh, or (pod, data, model) with ``pod`` > 1, over
    the default process group, whose world size must be their product
    (one rank per device).  A one-rank mesh needs no process group.
    Every rank must call this, in the same order: it creates the axis
    groups collectively."""
    if pod > 1:
        names, shape = ("pod", "data", "model"), (pod, data, model)
    else:
        names, shape = ("data", "model"), (data, model)
    n = int(np.prod(shape))
    if n == 1:
        return Mesh(names, shape)
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError(f"a mesh of {n} ranks needs an initialized "
                           "process group (parallel.mesh.spawn)")
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs {n} ranks, "
                         f"the process group has {dist.get_world_size()}")
    rank = dist.get_rank()
    ranks = np.arange(n).reshape(shape)
    groups: Dict[str, Any] = {}
    for i, axis in enumerate(names):
        if shape[i] == 1:
            continue
        if shape[i] == n:                  # the axis is the whole world
            groups[axis] = dist.group.WORLD
            continue
        rows = np.moveaxis(ranks, i, -1).reshape(-1, shape[i])
        for row in rows:                   # every rank creates every group
            g = dist.new_group([int(r) for r in row])
            if rank in row:
                groups[axis] = g
    return Mesh(names, shape, rank, groups, dist.get_backend())


def single_device_mesh() -> Mesh:
    return Mesh(("data", "model"), (1, 1))


def host_devices(device: str = "cuda") -> list:
    """The devices a host offers for placement: its cards, or the one
    CPU device (``device="cpu"``)."""
    import torch
    if device == "cpu":
        return [torch.device("cpu")]
    if device != "cuda":
        raise ValueError(f"device {device!r} not in ('cpu', 'cuda')")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def dp_submeshes(dp: int, tp: int = 1, device: str = "cuda") -> list:
    """The first ``dp * tp`` devices as ``dp`` rows of ``tp``: one device
    row per serving replica, row ``i`` the devices rank row ``i`` of a
    ``(dp, tp)`` mesh would hold.  Replicas never meet in a collective
    (a router moves requests, not activations), so each gets a row of its
    own rather than a slice of one mesh; a tp = 1 replica's row is one
    ``torch.device``, ``cuda:i``.  Raises ValueError when an axis is < 1
    or the host has fewer devices."""
    dp, tp = int(dp), int(tp)
    if dp < 1 or tp < 1:
        raise ValueError(f"dp_submeshes({dp}, {tp}): axes must be >= 1")
    devs = host_devices(device)
    need = dp * tp
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    return [tuple(devs[i * tp:(i + 1) * tp]) for i in range(dp)]


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """Axis sizes of a :class:`Mesh`, or a sizes dict as given."""
    return dict(mesh) if isinstance(mesh, dict) else mesh.sizes


def batch_shards(mesh) -> int:
    sizes = mesh_axis_sizes(mesh)
    n = 1
    for a in BATCH_AXES:
        n *= sizes.get(a, 1)
    return n


# --------------------------------------------------------------------------
# The active mesh: where the collectives find an axis's group
# --------------------------------------------------------------------------

class _Active(threading.local):
    mesh: Optional[Mesh] = None


_ACTIVE = _Active()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` the one whose groups the collectives use."""
    prev = _ACTIVE.mesh
    _ACTIVE.mesh = mesh
    try:
        yield mesh
    finally:
        _ACTIVE.mesh = prev


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE.mesh


def axis_group(axis: str):
    """The active mesh's process group for ``axis``."""
    mesh = _ACTIVE.mesh
    if mesh is None:
        raise RuntimeError(
            f"a collective over axis {axis!r} needs an active mesh "
            "(parallel.mesh.use_mesh; ShardedEngine makes its own active)")
    return mesh.group(axis)


# --------------------------------------------------------------------------
# Starting ranks
# --------------------------------------------------------------------------

def rank_device(rank: int, device: str):
    """The device rank ``rank`` runs on: the CPU, or card ``rank`` modulo
    the cards present (two ranks share a card on a one-card machine)."""
    import torch
    if device == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("device 'cuda' asked for, but no card is visible")
    return torch.device("cuda", rank % n)


def _rank_main(fn: Callable, rank: int, world: int, backend: str,
               device: str, store: str, threads: Optional[int], args: tuple,
               out) -> None:
    import torch
    import torch.distributed as dist
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = rank_device(rank, device)
        kw = {}
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            if backend == "nccl":
                kw["device_id"] = dev
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=world, **kw)
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, world: int, *, device: str,
          backend: str = "gloo", args: tuple = (), threads: Optional[int] = None,
          timeout: float = 1800.0) -> Any:
    """Run ``fn(rank, world, *args)`` on ``world`` ranks, each a process
    started with the ``spawn`` method inside a process group of
    ``backend`` ("gloo" or "nccl"), rank r on :func:`rank_device` of
    ``device`` ("cuda" or "cpu": required, the caller chooses).
    ``fn`` must be importable by name (module level).  The rendezvous is
    a ``FileStore`` in a fresh temporary directory, so concurrent calls
    never meet.  Returns rank 0's result; raises with the traceback of the
    first rank that failed, or when a rank neither returns nor fails
    within ``timeout`` seconds.  Every rank process is ended before this
    returns."""
    import torch.multiprocessing as mp
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r} not in ('cpu', 'cuda')")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_store_")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, device,
                               os.path.join(tmp, "store"), threads, args,
                               out))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        results: Dict[int, Any] = {}
        waited = 0.0
        while len(results) < world:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue.Empty:
                waited += 1.0
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if dead and out.empty():
                    raise RuntimeError(
                        f"spawn: rank(s) {dead} exited with code "
                        f"{[procs[r].exitcode for r in dead]} without a "
                        "result") from None
                if waited >= timeout:
                    raise RuntimeError(
                        f"spawn: a rank returned nothing within "
                        f"{timeout:.0f} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
        return results[0]
    finally:
        for p in procs:
            p.join(timeout=30)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)


__all__ = [
    "BATCH_AXES", "DATA_AXIS", "MODEL_AXIS", "POD_AXIS", "Mesh",
    "active_mesh", "axis_group", "batch_shards", "dp_submeshes",
    "host_devices", "make_host_mesh", "mesh_axis_sizes", "rank_device", "single_device_mesh", "spawn",
    "use_mesh",
]
