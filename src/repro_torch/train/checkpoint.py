"""Fault-tolerant checkpoint manager (the counterpart of
``repro/train/checkpoint.py``), writing the reference's files.

- **atomicity**: leaves are written into ``<dir>/tmp.step_N``, fsynced, then
  the directory is renamed to ``step_N``;
- **async**: a background thread serialises, so the train loop blocks only
  on the device-to-host copy;
- **restart**: ``latest_step`` / ``restore`` take the newest complete
  checkpoint; partly written ``tmp.*`` directories of a crashed run are
  ignored and removed;
- **the reference's layout**: one ``leaves.npz`` whose keys join each leaf's
  path with ``__`` (``params__layers__wq``, ``m__...``, ``step``), in the
  order ``jax.tree_util`` flattens the reference's TrainState (its fields in
  order, dict keys sorted), and a ``meta.json``; bf16 leaves are stored as
  the reference's numpy gives them (``V2``, their 16 bits), ``step`` as int32.
  A checkpoint written by either package restores into the other;
- **sharded state**: ``save(..., shardings=)`` gathers each leaf of a state
  held as the ranks' blocks (every rank of the mesh takes part) and the
  mesh's first rank writes the same ``leaves.npz``; ``restore(...,
  shardings=)`` gives each rank its block of every leaf, under any mesh
  (the reference's elastic re-shard).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from .step import TrainState, from_numpy, gather_whole

_SEP = "__"


def _walk(tree: Any, prefix: tuple = ()):
    """(path, leaf) in the reference's flattening order."""
    if isinstance(tree, TrainState):
        for f in dataclasses.fields(tree):
            yield from _walk(getattr(tree, f.name), prefix + (f.name,))
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _walk(tree[key], prefix + (str(key),))
    elif tree is not None:
        yield prefix, tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf, dtype=np.int32)        # TrainState.step


def _flatten(tree: Any, shardings: Any = None) -> dict[str, np.ndarray]:
    if shardings is None:
        return {_SEP.join(path): _host(leaf) for path, leaf in _walk(tree)}
    sh = dict(_walk(shardings))
    return {_SEP.join(path): _host(gather_whole(leaf, sh[path])
                                   if isinstance(leaf, torch.Tensor) else leaf)
            for path, leaf in _walk(tree)}


def _rebuild(template: Any, load, prefix: tuple = (), shardings: Any = None):
    def sub(name, node):
        return None if shardings is None else (
            getattr(shardings, name) if isinstance(shardings, TrainState) else shardings[name])

    if isinstance(template, TrainState):
        return TrainState(**{f.name: _rebuild(getattr(template, f.name), load,
                                              prefix + (f.name,), sub(f.name, template))
                             for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: _rebuild(v, load, prefix + (str(k),), sub(k, template))
                for k, v in template.items()}
    if template is None:
        return None
    return load(prefix, template, shardings)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._gc_tmp()

    # --- write ------------------------------------------------------------

    def save(self, step: int, tree: Any, blocking: bool = False,
             shardings: Any = None) -> None:
        """Write ``tree`` as step ``step`` (in a background thread unless
        ``blocking``).  ``shardings`` (a tree of ``Sharding`` shaped as
        ``tree``): the tree holds this rank's blocks; every rank of the mesh
        calls ``save``, the leaves are gathered, the first rank writes."""
        host = _flatten(tree, shardings)          # device->host happens here
        if shardings is not None:
            rules = next(sh for _, sh in _walk(shardings)).rules
            if any(rules.coords[a] for a in rules.mesh.axes):
                return
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, host), daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _write(self, step: int, host: dict[str, np.ndarray]) -> None:
        tmp = os.path.join(self.dir, f"tmp.step_{step:09d}")
        final = os.path.join(self.dir, f"step_{step:09d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "leaves.npz"), **host)
        meta = {"step": step, "keys": sorted(host.keys())}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic visibility
        self._gc_old()

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    # --- read -------------------------------------------------------------

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "meta.json")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template: Any, step: Optional[int] = None, device=None,
                shardings: Any = None) -> Any:
        """Load into the structure of ``template`` (a TrainState or nested
        dict; tensors give each leaf's dtype and, unless ``device`` is given,
        its device: a ``meta`` template needs ``device``).  ``shardings``:
        a tree of ``Sharding`` shaped as ``template``, whose leaves are then
        the whole leaves' shapes; each rank gets its block of every leaf."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step:09d}", "leaves.npz")

        def load(pth, leaf, sharding):
            arr = data[_SEP.join(pth)]
            if isinstance(leaf, torch.Tensor) and pth != ("step",):
                t = from_numpy(arr, leaf.dtype)
                if sharding is not None:
                    t = sharding.local(t)
                return t.to(device if device is not None else leaf.device)
            return int(arr)                # TrainState.step

        with np.load(path) as data:
            return _rebuild(template, load, shardings=shardings)

    # --- hygiene ----------------------------------------------------------

    def _gc_old(self) -> None:
        steps = self.steps()
        for s in steps[: max(len(steps) - self.keep, 0)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    def _gc_tmp(self) -> None:
        for name in os.listdir(self.dir):
            if name.startswith("tmp."):
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)
