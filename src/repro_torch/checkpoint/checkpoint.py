"""Parameter-tree checkpoints as ``.npz`` + JSON manifest: the port's copy of
``repro/checkpoint/checkpoint.py`` (``save_pytree``, ``load_manifest``,
``load_flat``, ``restore_pytree``) over nested dicts of tensors.

The file format is the reference's: one ``<path>.npz`` whose keys are the
'/'-joined key paths of the leaves in sorted-key order
(``params/mix/A_log``, ``heads/...``), written by an atomic rename, and a
sidecar ``<path>.npz.json`` manifest (keys, time, bytes, the caller's
metadata).  So each package reads the other's files, and a directory
that either package's rotating :class:`Checkpointer` wrote
(``ckpt_%08d.npz`` plus manifest) is restored by the other's.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_paths


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {"/".join(p): (leaf.detach().cpu().numpy()
                          if isinstance(leaf, torch.Tensor)
                          else np.asarray(leaf))
            for p, leaf in zip(tree_paths(tree), tree_leaves(tree))}


def save_pytree(path: str, tree, metadata: Optional[dict] = None) -> str:
    """Atomic save of a nested dict of tensors/arrays to ``<path>.npz``
    (+ sidecar manifest).  Returns the ``.npz`` path."""
    flat = _flatten(tree)
    folder = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".npz", dir=folder)
    os.close(fd)
    np.savez(tmp, **flat)
    final = _npz(path)
    shutil.move(tmp, final)
    manifest = {
        "keys": sorted(flat),
        "time": time.time(),
        "nbytes": int(sum(v.nbytes for v in flat.values())),
        "metadata": metadata or {},
    }
    with open(final + ".json", "w") as f:
        json.dump(manifest, f)
    return final


def load_manifest(path: str) -> dict:
    """The sidecar manifest :func:`save_pytree` wrote next to the ``.npz``
    (keys, byte count and the caller's ``metadata``)."""
    with open(_npz(path) + ".json") as f:
        return json.load(f)


def load_flat(path: str) -> Dict[str, np.ndarray]:
    with np.load(_npz(path)) as z:
        return {k: z[k] for k in z.files}


def restore_pytree(path: str, like) -> dict:
    """Restore into the structure of ``like`` (a nested dict of tensors):
    each leaf comes back with ``like``'s shape (checked), dtype and
    device."""
    flat = load_flat(path)
    out: dict = {}
    for p, leaf in zip(tree_paths(like), tree_leaves(like)):
        key = "/".join(p)
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        node = out
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=leaf.device, dtype=leaf.dtype)
    return out


class Checkpointer:
    """Rotating checkpoint directory with restore-latest.

    ``interval_rounds`` usually comes from
    ``core.fault.optimal_checkpoint_interval`` divided by the measured
    per-round wall time.  Saves copy the tree to the host (a
    synchronisation on the card); :meth:`restore_latest` returns it on
    ``like``'s device and dtypes."""

    def __init__(self, directory: str, keep: int = 3, interval_rounds: int = 1):
        self.dir = directory
        self.keep = keep
        self.interval = max(int(interval_rounds), 1)
        self.saves = 0
        os.makedirs(directory, exist_ok=True)

    def maybe_save(self, round_idx: int, tree, metadata=None) -> Optional[str]:
        if round_idx % self.interval:
            return None
        path = os.path.join(self.dir, f"ckpt_{round_idx:08d}")
        out = save_pytree(path, tree, {"round": round_idx, **(metadata or {})})
        self.saves += 1
        self._gc()
        return out

    def _gc(self):
        ckpts = sorted(self._list())
        for r, p in ckpts[: -self.keep]:
            for ext in ("", ".json"):
                try:
                    os.remove(p + ext)
                except OSError:
                    pass

    def _list(self) -> List[Tuple[int, str]]:
        out = []
        for f in os.listdir(self.dir):
            if f.startswith("ckpt_") and f.endswith(".npz"):
                out.append((int(f[5:13]), os.path.join(self.dir, f)))
        return out

    def latest(self) -> Optional[Tuple[int, str]]:
        ckpts = sorted(self._list())
        return ckpts[-1] if ckpts else None

    def restore_latest(self, like):
        """``(round, tree)`` of the newest checkpoint, restored into
        ``like``'s structure, device and dtypes; ``(None, None)`` when the
        directory holds none."""
        latest = self.latest()
        if latest is None:
            return None, None
        return latest[0], restore_pytree(latest[1], like)
