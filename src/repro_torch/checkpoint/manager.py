"""Checkpointing for training, as ``repro/checkpoint/manager.py``: atomic
directory commits, an async writer thread (checkpoint I/O overlaps the next
steps), retention and auto-resume.

Format (``repro``'s, so a checkpoint written by either package restores in
the other): one .npz per tree (params/opt/...) with the same flattened
keys (``_flatten``), and a JSON manifest; the directory is renamed into
place only after fsync (a crash mid-write never corrupts the latest
checkpoint). Leaves are full arrays; ``restore(device=...)`` puts them on
a device, and ``like=`` gives the restored tree the nesting of a template
(``_unflatten`` makes a tuple of every digit-keyed dict, as the
reference's does). A sharded tree (DTensor leaves) is saved as its full
arrays, gathered on every rank and written by global rank 0, so it
restores on any mesh or none; ``restore(shardings=...)`` places each
leaf's block on each rank.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.sharding import specs
from repro_torch.tree import tree_leaves, tree_map


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if isinstance(node, dict) and node and all(k.isdigit() for k in node):
            return tuple(fix(node[str(i)]) for i in range(len(node)))
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        return node
    return fix(root)


class CheckpointManager:
    def __init__(self, directory, *, keep: int = 3, async_save: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, *, metadata: Optional[dict] = None,
             block: bool = False):
        """Snapshot to host (device->host copy happens NOW, so training can
        mutate donated buffers), then write in a background thread."""
        self.wait()  # one in-flight save at a time
        flat = _flatten(tree)
        sharded = any(specs.sharding_of(v) is not None for v in flat.values())
        host_flat = {k: _host(v) for k, v in flat.items()}
        meta = {"step": int(step), "time": time.time(), **(metadata or {})}
        sync = block or not self.async_save
        if sharded and _rank() != 0:
            # a sharded tree: every rank gathers, global rank 0 writes
            if sync:
                _barrier()
            return

        def write():
            tmp = self.dir / f".tmp_step_{step}"
            final = self.dir / f"step_{step:010d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir()
            np.savez(tmp / "state.npz", **host_flat)
            (tmp / "manifest.json").write_text(json.dumps(meta))
            with open(tmp / "manifest.json") as f:
                os.fsync(f.fileno())
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)          # atomic commit
            self._gc()

        if not sync:
            self._thread = threading.Thread(target=self._guard(write), daemon=True)
            self._thread.start()
        else:
            write()
            if sharded:
                _barrier()

    def _guard(self, fn):
        def run():
            try:
                fn()
            except BaseException as e:   # surfaced on next wait()
                self._error = e
        return run

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # ------------------------------------------------------------- load
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, *, device=None,
                like=None, shardings=None):
        """Load a checkpoint: (tree, manifest), or (None, None) when there
        is none. Leaves are numpy arrays, or tensors on ``device`` when it
        is given; with ``like`` (a tree of the saved structure) the result
        takes its nesting: its lists, tuples and digit-keyed dicts. With
        ``shardings`` (a tree of ``specs.NamedSharding`` of the saved
        structure, on a mesh of any shape: elastic restore) each leaf
        becomes a DTensor holding this rank's block, on ``device`` (the
        mesh's device type by default)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        d = self.dir / f"step_{step:010d}"
        meta = json.loads((d / "manifest.json").read_text())
        with np.load(d / "state.npz") as z:
            flat = {k: z[k] for k in z.files}
        tree = _unflatten(flat)
        if shardings is not None:
            tree = _renest(tree, shardings)
            dev = device or tree_leaves(shardings)[0].mesh.device_type
            return tree_map(lambda a, sh: specs.distribute(
                torch.from_numpy(a), sh, dev), tree, shardings), meta
        if like is not None:
            tree = _renest(tree, like)
        if device is not None:
            tree = _to_device(tree, device)
        return tree, meta


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier():
    import torch.distributed as dist
    dist.barrier()


def _host(v):
    """A leaf as a host numpy array (a tensor is copied off its device; a
    DTensor's full array is gathered from the ranks first)."""
    sharding = specs.sharding_of(v)
    if sharding is not None:
        v = specs.full_tensor(v.to_local(), sharding)
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            raise TypeError("checkpoint leaves must have a numpy dtype; got "
                            "a bfloat16 tensor")
        return v.detach().to("cpu", copy=True).numpy()
    return np.asarray(v)


def _renest(tree, like):
    """``tree`` (as ``_unflatten`` gives it) in the nesting of ``like``."""
    if isinstance(like, dict):
        if isinstance(tree, (list, tuple)):      # a digit-keyed dict
            return {k: _renest(tree[int(k)], v) for k, v in like.items()}
        return {k: _renest(tree[k], v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_renest(t, v) for t, v in zip(tree, like))
    return tree


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)
