"""Atomic, manifest-versioned checkpointing with restart.

PyTorch counterpart of ``repro.training.checkpoint``, with its layout, so
either package restores the other's checkpoints::

    <dir>/step_00000120/
        manifest.json          # step, leaf count, shapes, dtypes
        leaf_00000.npy ...     # one file per tree leaf
    <dir>/LATEST               # atomic pointer (tmp + rename)

A tree is nested dicts (and lists or tuples) of tensors, numpy arrays or
scalars; its leaves are numbered in ``jax.tree.flatten``'s order, dict
keys sorted.  Writes go to ``step_*.tmp`` and are renamed only after
fsync, so a killed writer never corrupts the latest checkpoint.  bfloat16,
which numpy cannot hold, is stored as its byte view (uint8, last dim
doubled) with the logical shape and dtype in the manifest, as the
reference stores it.  ``restore(placements=...)`` places each leaf on a
mesh as a DTensor (the reference's ``shardings``: an elastic restart onto
whatever mesh the restarting job has).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

_NUMPY_NATIVE = {
    "float64", "float32", "float16", "int64", "int32", "int16", "int8",
    "uint64", "uint32", "uint16", "uint8", "bool", "complex64",
    "complex128",
}
_BYTE_VIEWS = {"bfloat16": torch.bfloat16}


def _leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.flatten``'s order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _leaves_up_to(like: Any, tree: Any) -> List[Any]:
    """``tree``'s node at each leaf position of ``like``, in
    :func:`_leaves`' order (a ``(mesh, placements)`` pair stays whole)."""
    if isinstance(like, dict):
        return [x for k in sorted(like)
                for x in _leaves_up_to(like[k], tree[k])]
    if isinstance(like, (list, tuple)):
        return [x for v, t in zip(like, tree) for x in _leaves_up_to(v, t)]
    return [] if like is None else [tree]


def _unflatten(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves taken in turn from ``leaves``
    (an iterator)."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return None if like is None else next(leaves)


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str, list]:
    """(array to store, logical dtype, logical shape) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        from torch.distributed.tensor import DTensor
        t = leaf.detach()
        if isinstance(t, DTensor):           # its whole value (a collective)
            t = t.full_tensor()
        t = t.cpu()
        if t.dtype == torch.bfloat16:
            return (t.contiguous().view(torch.uint8).numpy(), "bfloat16",
                    list(t.shape))
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    logical = str(arr.dtype)
    if logical not in _NUMPY_NATIVE:
        raise TypeError(f"checkpoint: no storage for dtype {logical}")
    return arr, logical, list(arr.shape)


def save(directory: str, step: int, tree: Any) -> str:
    """Atomic save. Returns the checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:08d}"
    final = os.path.join(directory, name)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves = _leaves(tree)
    manifest = {"step": step, "num_leaves": len(leaves), "leaves": []}
    for i, leaf in enumerate(leaves):
        arr, logical, shape = _to_numpy(leaf)
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
        manifest["leaves"].append({"shape": shape, "dtype": logical})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, final)

    latest_tmp = os.path.join(directory, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.rename(latest_tmp, os.path.join(directory, "LATEST"))
    return final


def latest_step(directory: str) -> Optional[int]:
    ptr = os.path.join(directory, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    path = os.path.join(directory, name)
    if not os.path.exists(os.path.join(path, "manifest.json")):
        return None
    return int(name.split("_")[1])


def restore(directory: str, like: Any, step: Optional[int] = None,
            device: Union[str, torch.device, None] = "cpu",
            placements: Any = None) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (a tree of tensors, ``meta``
    ones included, or of anything with ``shape`` and a torch ``dtype``):
    each leaf as a tensor of the like leaf's dtype on ``device``.
    ``placements``, a tree of ``like``'s structure holding a ``(mesh,
    placements)`` pair or None per leaf, restores a leaf with a pair as a
    DTensor on that mesh (``distribute_tensor``; every rank reads the
    file, so each takes its shards from its own copy)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    leaves_like = _leaves(like)
    if manifest["num_leaves"] != len(leaves_like):
        raise ValueError(
            f"checkpoint has {manifest['num_leaves']} leaves, expected "
            f"{len(leaves_like)} — structure mismatch")
    placed = (_leaves_up_to(like, placements) if placements is not None
              else [None] * len(leaves_like))
    out = []
    for i, (ref, where) in enumerate(zip(leaves_like, placed)):
        t = torch.from_numpy(np.load(os.path.join(path, f"leaf_{i:05d}.npy")))
        meta = manifest["leaves"][i]
        if meta["dtype"] not in _NUMPY_NATIVE:
            if meta["dtype"] not in _BYTE_VIEWS:
                raise TypeError(f"leaf {i}: no torch dtype for "
                                f"{meta['dtype']}")
            t = t.view(_BYTE_VIEWS[meta["dtype"]]).reshape(meta["shape"])
        want_shape = tuple(ref.shape)
        if tuple(t.shape) != want_shape:
            raise ValueError(f"leaf {i}: checkpoint shape {tuple(t.shape)} "
                             f"!= expected {want_shape}")
        if where is None:
            out.append(t.to(device=device, dtype=ref.dtype))
            continue
        from torch.distributed.tensor import distribute_tensor
        mesh, pl = where
        out.append(distribute_tensor(
            t.to(device=mesh.device_type, dtype=ref.dtype), mesh, pl,
            src_data_rank=None))
    return _unflatten(like, iter(out)), step


def prune(directory: str, keep: int = 3):
    """Keep the newest ``keep`` checkpoints (never the LATEST target)."""
    if not os.path.isdir(directory):
        return
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(directory)
        if n.startswith("step_") and not n.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
