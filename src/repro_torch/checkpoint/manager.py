"""Checkpointing: atomic, async, manifest'd.

The full state of a training stream (params, optimiser moments, step,
data cursor) is saved so the stream can be interrupted and resumed at
will.  The layout and the files are the reference's::

    <dir>/step_<n>.tmp/ → write leaves (npz) + manifest.json → atomic rename
    <dir>/step_<n>/
    <dir>/LATEST        → "step_<n>" (written after the rename commits)

Leaves are named by their key paths (``params/groups/0/0/mixer/wq``,
``opt/count``) and written in the reference's order (``keypaths``), each
an ``.npy`` member of ``leaves.npz`` as ``np.savez`` writes it.  A bf16
leaf is written as the reference writes one: its 16 bits, under the
header ml_dtypes' bfloat16 gets (``'<V2'``, which numpy reads back as
``|V2``), with ``"bfloat16"`` in the manifest; so every member is the
reference's bytes.  On restore each leaf is read back through the
manifest's dtype, so the port restores the reference's bf16 checkpoints
too (the reference itself cannot: fault C10).

Async: ``save(..., blocking=False)`` copies every leaf to host memory
before it returns (the train step updates its tensors in place), then
writes on a background thread; ``wait()`` joins.  Keep-last-k GC after
each commit.

Checkpoints hold full leaves.  ``restore(..., shardings=...)`` places each
leaf as this rank's shard under a mesh's placements (a tree of
``parallel.sharding.NamedSharding``), which may be another mesh than the
one that saved: that is the elastic restart (``runtime/elastic.py``).
"""

from __future__ import annotations

import json
import os
import shutil
import zipfile
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import DeviceLike, keypaths, resolve_device
from ..models.layers import META

#: the ``.npy`` header's dtype of a bf16 leaf: ml_dtypes' bfloat16 as
#: ``np.savez`` spells it
BF16_DESCR = "<V2"


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    """A host copy of ``leaf``; bf16 as its bits (int16)."""
    host = leaf.detach().to("cpu", copy=True).contiguous()
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy()
    return host.numpy()


def _dtype_name(leaf: torch.Tensor) -> str:
    return str(leaf.dtype).removeprefix("torch.")


def _flatten(tree: Any) -> Dict[str, Any]:
    """{key: (host array, dtype name)} in the reference's leaf order."""
    return {keypaths.key(path): (_to_numpy(leaf), _dtype_name(leaf))
            for path, leaf in keypaths.leaves_with_path(tree)}


def _savez(path: str, flat: Dict[str, Any]) -> None:
    """``np.savez(path, **arrays)``'s file, a bf16 leaf's member under the
    reference's header."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (arr, dtype) in flat.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if dtype == "bfloat16":
                    np.lib.format.write_array_header_1_0(
                        fid, {"descr": BF16_DESCR, "fortran_order": False,
                              "shape": arr.shape})
                    fid.write(arr.tobytes())
                else:
                    np.lib.format.write_array(fid, arr)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.array(arr, order="C")          # a writable copy, 0-d kept
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.astype(dtype, copy=False))


def _unflatten_into(template: Any, flat: Dict[str, np.ndarray],
                    dtypes: Dict[str, str], device: DeviceLike,
                    shardings: Any = None) -> Any:
    place = {}
    if shardings is not None:
        place = {keypaths.key(p): s
                 for p, s in keypaths.leaves_with_path(shardings)}

    def load(path, leaf):
        key = keypaths.key(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf '{key}'")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"leaf '{key}' shape {arr.shape} != template {leaf.shape}")
        dev = device if device is not None else leaf.device
        if torch.device(dev) == META:
            dev = resolve_device(None)
        t = _from_numpy(arr, dtypes.get(key, arr.dtype.name))
        if key in place:
            t = place[key].shard(t)
        return t.to(dev)

    return keypaths.map_with_path(load, template)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Any, *, blocking: bool = True,
             extra: Optional[Dict[str, Any]] = None) -> None:
        # snapshot to host *before* returning: training mutates buffers
        flat = _flatten(state)
        meta = {"step": int(step), "extra": extra or {},
                "leaves": {k: [list(v.shape), dt]
                           for k, (v, dt) in flat.items()}}
        if blocking:
            self._write(step, flat, meta)
        else:
            self.wait()
            self._pending = self._pool.submit(self._write, step, flat, meta)

    def _write(self, step: int, flat, meta) -> None:
        name = f"step_{step:08d}"
        tmp = os.path.join(self.directory, name + ".tmp")
        final = os.path.join(self.directory, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        _savez(os.path.join(tmp, "leaves.npz"), flat)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        latest = os.path.join(self.directory, "LATEST.tmp")
        with open(latest, "w") as f:
            f.write(name)
        os.replace(latest, os.path.join(self.directory, "LATEST"))
        self._gc()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self):
        out = []
        for n in os.listdir(self.directory):
            if n.startswith("step_") and not n.endswith(".tmp"):
                out.append(int(n.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.directory, "LATEST")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            name = f.read().strip()
        step = int(name.split("_")[1])
        return step if step in self.all_steps() else (
            self.all_steps()[-1] if self.all_steps() else None)

    def restore(self, step: int, template: Any, *,
                device: DeviceLike = None,
                shardings: Optional[Any] = None) -> Any:
        """The saved leaves in ``template``'s structure, each checked
        against its template leaf's (full) shape, in the manifest's dtype,
        on ``device`` (default: the template leaf's; a ``meta`` template's
        leaves go to the default device).

        ``shardings`` (a tree like ``template``'s of
        ``parallel.sharding.NamedSharding``, or a part of it) makes each
        leaf it places this rank's shard; it may come from another mesh
        than the one that saved.
        """
        d = os.path.join(self.directory, f"step_{step:08d}")
        dtypes = {k: v[1] for k, v in self.manifest(step)["leaves"].items()}
        # the archive's members are read as asked for: one full leaf at a time
        with np.load(os.path.join(d, "leaves.npz")) as z:
            return _unflatten_into(template, z, dtypes, device, shardings)

    def manifest(self, step: int) -> Dict[str, Any]:
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f)
