"""Preemption-safe checkpoints of the port, on the reference's on-disk
layout (counterpart of ``repro/train/checkpoint.py``):

    <dir>/step_00000123.tmp/          (written)
        manifest.json                 (tree, shapes, dtypes, step)
        shard_000.npz ...             (leaves, ~512 MB per file)
    <dir>/step_00000123/              (atomic rename commit)

* Leaves are numbered in the reference's flatten order (dict keys
  sorted, lists in order, a ``QTensor`` as its payload then its
  scales), so a checkpoint of either package restores into the same
  state tree of the other.
* The commit is a rename: a killed writer never corrupts the latest
  complete checkpoint, and ``latest_step`` skips ``.tmp`` directories.
* ``restore`` writes the loaded arrays **into** the target state's
  tensors, cast to their dtypes, on their devices (a ``ParamTree``
  keeps its ``nn.Parameter`` objects), and returns the target.
* ``AsyncCheckpointer`` copies the state to the host, then writes it on
  a background thread; at most one write is pending, and ``wait()``
  joins it and raises its error.
* **Sharded state** (leaves placed by ``parallel/sharding.place`` or
  ``optim/adamw.init`` on a live mesh): every rank calls ``save``, which
  all-gathers each placed leaf whole; global rank 0 writes the same
  layout as one device would, and the ranks meet at a barrier after it.
  ``restore`` gives each placed target leaf its slice of the whole
  array, so a checkpoint written on one mesh restores onto another
  mesh's placement (elastic restore), or onto one device.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.parallel import sharding as sh

SHARD_BYTES = 512 << 20


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _whole(t):
    """A leaf on the host, whole: a placed leaf all-gathered first (a
    collective)."""
    return _host(sh.gather_tensor(t) if isinstance(t, torch.Tensor) else t)


def _sharded_writer(state) -> Tuple[bool, bool]:
    """(the state holds placed leaves, this process writes): with placed
    leaves only global rank 0 writes."""
    placed = any(sh.placement(x) is not None for x in tree_leaves(state))
    if not placed:
        return False, True
    import torch.distributed as dist
    return True, dist.get_rank() == 0


def _skeleton(tree) -> Any:
    """The tree's structure with every leaf as ``*`` (the manifest's
    ``treedef``)."""
    return tree_map(lambda _x: "*", tree)


def save(ckpt_dir: str, state, step: int) -> Path:
    """Write ``state`` (a tree of tensors or arrays) as step ``step``.
    Placed leaves are gathered whole; then global rank 0 writes and
    every rank waits at a barrier for it."""
    d = Path(ckpt_dir)
    final = d / f"step_{step:08d}"
    placed, writes = _sharded_writer(state)
    arrays = [_whole(x) for x in tree_leaves(state)]
    if writes:
        _write(d, final, state, step, arrays)
    if placed:
        import torch.distributed as dist
        dist.barrier()
    return final


def _write(d: Path, final: Path, state, step: int,
           arrays: List[np.ndarray]) -> None:
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest: Dict[str, Any] = {
        "step": step,
        "treedef": json.dumps(_skeleton(state)),
        "num_leaves": len(arrays),
        "leaves": [{"shape": list(a.shape), "dtype": str(a.dtype)}
                   for a in arrays],
        "shards": [],
    }
    shard: Dict[str, np.ndarray] = {}
    shard_bytes, shard_id = 0, 0

    def flush() -> None:
        nonlocal shard, shard_bytes, shard_id
        if not shard:
            return
        np.savez(tmp / f"shard_{shard_id:03d}.npz", **shard)
        manifest["shards"].append(
            {"file": f"shard_{shard_id:03d}.npz", "keys": list(shard)})
        shard, shard_bytes = {}, 0
        shard_id += 1

    for i, a in enumerate(arrays):
        shard[f"leaf_{i}"] = a
        shard_bytes += a.nbytes
        if shard_bytes >= SHARD_BYTES:
            flush()
    flush()
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit


def latest_step(ckpt_dir: str) -> Optional[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.iterdir()
             if p.is_dir() and p.name.startswith("step_")
             and not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def load_arrays(ckpt_dir: str, step: Optional[int] = None
                ) -> Tuple[List[np.ndarray], int]:
    """Every leaf of a checkpoint as numpy, in flatten order, and its
    step (the latest when ``step`` is None)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step:08d}"
    with open(d / "manifest.json") as f:
        manifest = json.load(f)
    flat: Dict[str, np.ndarray] = {}
    for part in manifest["shards"]:
        with np.load(d / part["file"]) as z:
            for k in part["keys"]:
                flat[k] = z[k]
    return [flat[f"leaf_{i}"] for i in range(manifest["num_leaves"])], step


@torch.no_grad()
def restore(ckpt_dir: str, target_state, step: Optional[int] = None):
    """Load a checkpoint into ``target_state`` (a tree of tensors: each
    leaf is overwritten in place, cast to its dtype, on its device; a
    placed leaf with its slice of the whole) -> (target_state, step)."""
    arrays, step = load_arrays(ckpt_dir, step)
    leaves = tree_leaves(target_state)
    if len(leaves) != len(arrays):
        raise ValueError(f"checkpoint step {step} holds {len(arrays)} "
                         f"leaves, the target {len(leaves)}")
    for i, (t, a) in enumerate(zip(leaves, arrays)):
        pl = sh.placement(t)
        want = tuple(t.shape) if pl is None else pl.shape
        if want != a.shape:
            raise ValueError(f"leaf {i}: checkpoint {a.shape}, target "
                             f"{want}")
        src = torch.as_tensor(np.array(a))
        if pl is not None:
            src = sh.local_part(src, pl.spec, pl.rules)
        t.copy_(src)
    return target_state, step


class AsyncCheckpointer:
    """One background writer; at most one pending save (back-pressure)."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._pending: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, state, step: int) -> None:
        """Copy ``state`` to the host (placed leaves gathered whole: every
        rank calls this) and write it in the background (placed: global
        rank 0 only)."""
        self.wait()
        _, writes = _sharded_writer(state)
        host_state = tree_map(_whole, state)
        if not writes:
            return

        def work():
            try:
                save(self.ckpt_dir, host_state, step)
            except BaseException as e:  # noqa: BLE001
                self.last_error = e

        self._pending = threading.Thread(target=work, daemon=True)
        self._pending.start()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
