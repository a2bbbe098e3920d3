"""Checkpointing: atomic, async, keep-K with milestones: the JAX package's
``train/checkpoint.py`` in PyTorch, on its on-disk format.

* **Atomic**: write to ``<dir>/tmp.<step>.<pid>`` then ``os.replace`` —
  a preempted writer never corrupts the latest checkpoint.
* **Async**: ``save_async`` copies the state to host memory
  synchronously, then writes in a background thread so the train loop
  keeps stepping.
* **Keep-K + milestones**: bounded disk with periodic permanent keeps.
* **Format**: ``arrays.npz`` (one array per leaf, keyed by its tree path,
  ``params/segments/0/b0/mixer/wq``) and ``manifest.json`` (step, time,
  sorted keys, meta), the reference's, so a float32 checkpoint written
  by either package restores in the other.  numpy has no bfloat16
  without ``ml_dtypes``: a bf16 leaf is stored as its raw 16-bit pattern
  (int16, as ``bridge.py`` carries it) and the manifest's ``dtypes``
  names every leaf's dtype.

* **Elastic**: the files hold whole leaves and logical keys only, as
  the reference's.  On a mesh (``mesh=`` and ``shards=``, a tree of the
  state's structure holding each leaf's ``parallel.sharding.Block``: a
  parameter's model block, a ZeRO-1 moment's model and data block,
  ``loop.state_shards``) a save all-gathers every block into its whole
  leaf on every rank, rank 0 writes, and the others wait on a barrier;
  a restore reads whole leaves and cuts this rank's block of each
  sharded one along both axes.  So a checkpoint saved on (data 4, model
  2) restores on (2, 4), at data 2 or on one device bit for bit, and
  crosses to the reference and back.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models.params import tree_map, tree_paths, tree_unflatten

def _flat(tree) -> Dict[str, Any]:
    return dict(tree_paths(tree))


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy (bf16 as its raw int16 pattern)."""
    t = t.detach().to("cpu", copy=True)
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _snapshot(state) -> Dict[str, Any]:
    flat = _flat(state)
    return {"arrays": {k: _host(torch.as_tensor(v)) for k, v in flat.items()},
            "dtypes": {k: str(torch.as_tensor(v).dtype).replace("torch.", "")
                       for k, v in flat.items()}}


class CheckpointManager:
    """Checkpoints under ``directory``; with ``mesh`` and ``shards`` (a
    tree of the state's structure: each leaf's ``Block`` on this rank,
    or None) every rank of the mesh calls :meth:`save`,
    :meth:`save_async`, :meth:`wait` and :meth:`restore` together."""

    def __init__(self, directory: str, keep: int = 3,
                 milestone_every: int = 0, *, mesh=None, shards=None):
        self.dir = directory
        self.keep = keep
        self.milestone_every = milestone_every
        self.mesh = mesh
        self.shards = dict(tree_paths(shards)) if shards is not None \
            else {}
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    @property
    def _writer(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def _barrier(self):
        if self.mesh is not None and self.mesh.size > 1:
            import torch.distributed as dist
            dist.barrier()

    def _whole(self, state):
        """``state`` with every sharded leaf all-gathered whole (a
        collective over each block's axes)."""
        if not any(sh is not None for sh in self.shards.values()):
            return state
        from ..parallel.mesh import use_mesh
        keys = iter(k for k, _ in tree_paths(state))

        def whole(t):
            sh = self.shards.get(next(keys))
            return t if sh is None else sh.gather(t)

        with use_mesh(self.mesh):
            return tree_map(whole, state)

    # -- paths ------------------------------------------------------------
    def step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                manifest = os.path.join(self.dir, name, "manifest.json")
                if os.path.exists(manifest):
                    steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save ---------------------------------------------------------------
    def save(self, state, step: int, meta: Optional[Dict] = None):
        """Synchronous atomic save (after any background write)."""
        self.wait()
        state = self._whole(state)
        if self._writer:
            self._write(_snapshot(state), step, meta or {})
        self._barrier()

    def save_async(self, state, step: int, meta: Optional[Dict] = None):
        """Snapshot to host memory now, write in the background (the
        ranks other than 0 only take part in the gather; :meth:`wait`
        joins them all)."""
        self.wait()
        state = self._whole(state)
        if not self._writer:
            return
        host = _snapshot(state)
        self._thread = threading.Thread(
            target=self._write, args=(host, step, meta or {}), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._barrier()

    def _write(self, host: Dict[str, Any], step: int, meta: Dict):
        tmp = os.path.join(self.dir, f"tmp.{step}.{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **host["arrays"])
        manifest = {
            "step": step,
            "time": time.time(),
            "keys": sorted(host["arrays"]),
            "dtypes": host["dtypes"],
            "meta": meta,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        final = self.step_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        if self.keep <= 0:
            return
        for s in steps[:-self.keep]:
            if self.milestone_every and s % self.milestone_every == 0:
                continue
            shutil.rmtree(self.step_dir(s), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def restore(self, abstract_state, step: Optional[int] = None, *,
                device: Union[str, torch.device] = "cuda"):
        """Restore the checkpoint of ``step`` (the latest when None) onto
        ``device``.  ``abstract_state``: a tree of tensors (meta or real)
        whose structure, shapes and dtypes the result takes (a sharded
        leaf's: this rank's block, cut from the whole one on disk).
        Returns (state, manifest)."""
        dev = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self.step_dir(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        dtypes = manifest.get("dtypes", {})
        flat_abs = _flat(abstract_state)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            missing = set(flat_abs) - set(data.files)
            if missing:
                raise KeyError(
                    f"checkpoint missing keys: {sorted(missing)[:5]}")
            leaves = []
            for key, ref in flat_abs.items():
                arr = data[key]
                sh = self.shards.get(key)
                shape = tuple(arr.shape) if sh is None else sh.shape(
                    arr.shape)
                if shape != tuple(ref.shape):
                    raise ValueError(f"{key}: checkpoint shape {arr.shape} "
                                     f"{'' if sh is None else f'({sh}) '}"
                                     f"!= {tuple(ref.shape)}")
                t = torch.from_numpy(arr)
                if dtypes.get(key) == "bfloat16":
                    t = t.view(torch.bfloat16)
                if sh is not None:
                    t = sh.take(t).contiguous()
                leaves.append(t.to(device=dev, dtype=ref.dtype))
        return tree_unflatten(abstract_state, leaves), manifest
