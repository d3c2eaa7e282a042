"""Checkpoint and resume of odometry state.

Counterpart of ``small_gicp_tpu/utils/checkpoint.py``, with its ``.npz``
layout: ``leaf_<i>`` arrays, ``__schema_version__`` = 2, ``__keypaths__``
(one name a leaf) and ``__treedef__`` (a description for humans, never
compared). A checkpoint written by either package loads into the other's
engine of the same type and parameters.

The port has no pytrees, so a small flattener stands in for JAX's: it
recurses through dicts (keys sorted, as JAX sorts them), lists, tuples and
dataclasses (fields in declaration order). Tensors and arrays are leaves;
``None`` holds none; any other field (a voxel map's ``num_offsets``,
``cell_capacity``, ``has_covs``, ...) is static and comes from the template
at load time, as ``struct.field(pytree_node=False)`` does in the JAX maps.
A leaf's name is the dict key, sequence index or field name at each level,
joined by ``/``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, List, Tuple

import numpy as np
import torch

SCHEMA_VERSION = 2


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic))


def _children(x):
    """(names, children) of a container, or None for a leaf or a static."""
    if isinstance(x, dict):
        keys = sorted(x)
        return [str(k) for k in keys], [x[k] for k in keys]
    if isinstance(x, (list, tuple)):
        return [str(i) for i in range(len(x))], list(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        fs = [f for f in dataclasses.fields(x) if f.init]
        return [f.name for f in fs], [getattr(x, f.name) for f in fs]
    return None


def _flatten_named(tree: Any) -> Tuple[List[str], List[Any]]:
    names: List[str] = []
    leaves: List[Any] = []

    def walk(x, path):
        if _is_leaf(x):
            names.append("/".join(path))
            leaves.append(x)
            return
        kids = _children(x)
        if kids is None:
            return
        for name, child in zip(*kids):
            walk(child, path + [name])

    walk(tree, [])
    return names, leaves


def _unflatten(template: Any, leaves) -> Any:
    it = iter(leaves)

    def build(x):
        if _is_leaf(x):
            return next(it)
        if isinstance(x, dict):
            return {k: build(x[k]) for k in sorted(x)}
        if isinstance(x, list):
            return [build(c) for c in x]
        if isinstance(x, tuple):
            return tuple(build(c) for c in x)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: build(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.init})
        return x

    return build(template)


def _describe(tree: Any) -> str:
    """A one-line sketch of the structure; kept for humans, never compared."""
    if _is_leaf(tree):
        return "*"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_describe(c) for c in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        fs = [f for f in dataclasses.fields(tree) if f.init]
        return f"{type(tree).__name__}(" + ", ".join(
            f"{f.name}={_describe(getattr(tree, f.name))}" for f in fs) + ")"
    return repr(tree)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _np_dtype(x) -> np.dtype:
    if isinstance(x, torch.Tensor):
        return torch.empty((), dtype=x.dtype).numpy().dtype
    return np.asarray(x).dtype


def _restored(i: int, name: str, arr: np.ndarray, tmpl, hint: str = ""):
    """The saved array ``arr`` placed as the template leaf is (a tensor on
    its device, or an array); a shape or dtype that differs raises
    ``ValueError`` naming the leaf."""
    if arr.shape != tuple(tmpl.shape) or arr.dtype != _np_dtype(tmpl):
        raise ValueError(f"checkpoint leaf {i} ({name}): saved {arr.shape}/{arr.dtype} vs "
                         f"template {tuple(tmpl.shape)}/{_np_dtype(tmpl)}{hint}")
    if isinstance(tmpl, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(tmpl.device)
    return np.array(arr)


def save_pytree(path: str, tree: Any) -> None:
    """Serialize a tree of tensors and arrays to an ``.npz`` file."""
    names, leaves = _flatten_named(tree)
    arrays = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
    arrays["__schema_version__"] = np.asarray(SCHEMA_VERSION)
    arrays["__keypaths__"] = np.asarray(names)
    arrays["__treedef__"] = np.frombuffer(_describe(tree).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def _check_keypaths(data, template_names) -> None:
    """Raise with a name-level diff when the checkpoint's leaves are not the
    template's. A v1 file (no ``__keypaths__``) passes with a warning: its
    structure is checked only by leaf count, shape and dtype."""
    version = (int(data["__schema_version__"])
               if "__schema_version__" in data.files else 1)
    if version < 2:
        warnings.warn(
            "v1 checkpoint: structure verified only by leaf count/shape/dtype "
            "(its treedef record cannot be compared across packages)",
            stacklevel=3)
        return
    saved_names = [str(s) for s in data["__keypaths__"]]
    if saved_names != list(template_names):
        missing = sorted(set(template_names) - set(saved_names))
        extra = sorted(set(saved_names) - set(template_names))
        raise ValueError(
            "checkpoint structure mismatch (by leaf names):\n"
            f"  in engine but not checkpoint: {missing}\n"
            f"  in checkpoint but not engine: {extra}\n"
            "construct the engine with the same parameters and warm "
            "state as when saving")


def _saved_leaves(data) -> list:
    n = sum(1 for k in data.files if k.startswith("leaf_"))
    return [data[f"leaf_{i}"] for i in range(n)]


def load_pytree(path: str, template: Any) -> Any:
    """Restore a tree saved by ``save_pytree``.

    ``template`` gives the structure and the static fields; its leaves are
    replaced by the checkpoint's, each placed on the template leaf's device.
    Raises ``ValueError`` if the leaf names, count, or any shape or dtype
    differ, that is, if the checkpoint was written with another
    configuration.
    """
    with np.load(path) as data:
        names, leaves = _flatten_named(template)
        _check_keypaths(data, names)
        saved = _saved_leaves(data)
    if len(saved) != len(leaves):
        raise ValueError("checkpoint leaf count mismatch")
    return _unflatten(template, [_restored(i, *args)
                                 for i, args in enumerate(zip(names, saved, leaves))])


def _state_template(odom, saved_has) -> dict:
    template = {"T_world": odom.T_world, "traj": np.zeros((0, 4, 4))}
    if hasattr(odom, "T_delta") and saved_has("T_delta"):
        template["T_delta"] = odom.T_delta
    if hasattr(odom, "voxelmap"):
        template["voxelmap"] = odom.voxelmap
    if hasattr(odom, "_first") and saved_has("first"):
        template["first"] = np.asarray(odom._first)
    if getattr(odom, "_prev", None) is not None:
        template["prev"] = odom._prev
    if getattr(odom, "_prev_map", None) is not None:
        template["prev_map"] = odom._prev_map
    return template


def save_odometry_state(path: str, odom) -> None:
    """Snapshot a streaming engine's resumable state: the pose, the motion
    prediction, the map or previous cloud, the first-frame flag and the
    trajectory so far."""
    state = {
        "T_world": odom.T_world,
        "traj": np.stack(odom.traj) if odom.traj else np.zeros((0, 4, 4)),
    }
    if hasattr(odom, "T_delta"):
        state["T_delta"] = odom.T_delta
    if hasattr(odom, "voxelmap"):
        state["voxelmap"] = odom.voxelmap
    if hasattr(odom, "_first"):
        state["first"] = np.asarray(odom._first)
    if getattr(odom, "_prev", None) is not None:
        state["prev"] = odom._prev
    if getattr(odom, "_prev_map", None) is not None:
        state["prev_map"] = odom._prev_map
    save_pytree(path, state)


def load_odometry_state(path: str, odom) -> None:
    """Restore state saved by ``save_odometry_state`` (by either package)
    into a freshly constructed engine of the same type and parameters.

    The optional leaves (``T_delta``, ``first``) are expected only where the
    checkpoint holds them, so files written before they existed still load.
    Every leaf but the trajectory must match the engine's shape and dtype:
    a wrong capacity raises ``ValueError`` naming the leaf.
    """
    with np.load(path) as data:
        saved_names = ({str(s) for s in data["__keypaths__"]}
                       if "__keypaths__" in data.files else None)
        template = _state_template(
            odom, lambda n: saved_names is not None and n in saved_names)
        names, leaves = _flatten_named(template)
        saved = _saved_leaves(data)
        if len(saved) != len(leaves):
            raise ValueError(
                "checkpoint/template mismatch — construct the engine with the "
                "same parameters and warm state (e.g. first frame) as when saving")
        _check_keypaths(data, names)
    out = []
    for i, (name, tmpl, arr) in enumerate(zip(names, leaves, saved)):
        if name == "traj":  # its length is the checkpoint's own
            if arr.ndim != 3 or arr.shape[1:] != (4, 4):
                raise ValueError(f"trajectory leaf has shape {arr.shape}, "
                                 "expected [F,4,4]")
            out.append(np.array(arr))
        else:
            out.append(_restored(i, name, arr, tmpl, " — construct the engine with "
                                 "the same parameters (e.g. map_capacity) as when saving"))
    restored = _unflatten(template, out)
    odom.T_world = restored["T_world"]
    odom.traj = [p for p in restored["traj"]]
    if "T_delta" in restored:
        odom.T_delta = restored["T_delta"]
    if "voxelmap" in restored:
        odom.voxelmap = restored["voxelmap"]
        odom._first = (bool(restored["first"]) if "first" in restored
                       else len(odom.traj) == 0)
    if "prev" in restored:
        odom._prev = restored["prev"]
    if "prev_map" in restored:
        odom._prev_map = restored["prev_map"]
