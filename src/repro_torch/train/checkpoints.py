"""Checkpointing: save / restore parameter and optimizer trees as npz (port
of ``repro/train/checkpoints.py``).

The file format is the JAX package's, key for key: a tree of dicts and
lists is flattened to ``/``-joined path keys (``#i`` for list items, a
zero-size marker entry for an empty container), so a checkpoint either
package writes loads into the other. The port's own state is keyed by
flat parameter names (``layers.<l>.attn.wq``); ``interop.params_to_jax``
and ``interop.opt_state_to_jax`` lay it out as the JAX trees (the layers
restacked over cycles) before a save, and ``interop.params_from_jax`` /
``opt_state_from_jax`` take a loaded tree back. Tensors cross to the host
explicitly: every leaf is a numpy array in the file and in what
``load_checkpoint`` returns; the caller moves them to its device.

``load_checkpoint(path, template=...)`` validates the loaded tree against a
template (the same paths, shapes and dtypes; the leaves may be numpy
arrays, tensors or anything with ``shape`` and ``dtype``) and fails with
the JAX package's per-path report.

``save_train_state`` / ``load_train_state`` add what a bit-exact resume of
the elastic loop needs: the step counter, the active ``Schedule`` and
``DeviceAssignment``, the RNG key and scalar loop state (speed EMAs, fault
counters). The caller passes parameters and optimizer state in canonical
element order (ZeRO layouts re-laid out first), so a checkpoint restores
onto any mesh size and sync mode.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.assignment import DeviceAssignment
from repro_torch.core.schedule import Schedule

# empty containers have no leaves, so they would vanish from a path-keyed
# flat dict; a zero-size marker entry keeps them round-trippable (a config
# with no remainder blocks has params["rest"] == [])
_EMPTY_LIST = "__empty_list__"
_EMPTY_DICT = "__empty_dict__"


def _host(x) -> np.ndarray:
    """A leaf as a numpy array (a tensor is copied to the host)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _dtype(x) -> np.dtype:
    if isinstance(x, torch.Tensor):
        return np.dtype(str(x.dtype).replace("torch.", ""))
    return np.dtype(x.dtype)


def _walk(tree, prefix, leaf, empty) -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        if not tree:
            out[f"{prefix}{_EMPTY_DICT}"] = empty
        for k in sorted(tree):
            out.update(_walk(tree[k], f"{prefix}{k}/", leaf, empty))
    elif isinstance(tree, (list, tuple)):
        if not tree:
            out[f"{prefix}{_EMPTY_LIST}"] = empty
        for i, v in enumerate(tree):
            out.update(_walk(v, f"{prefix}#{i}/", leaf, empty))
    else:
        out[prefix[:-1]] = leaf(tree)
    return out


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    return _walk(tree, prefix, _host, np.zeros(0))


def _unflatten(flat: Dict[str, np.ndarray]):
    root: Any = {}
    for path, arr in flat.items():
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr

    def rebuild(node):
        if not isinstance(node, dict):
            return np.asarray(node)
        if _EMPTY_LIST in node:
            return []
        if _EMPTY_DICT in node:
            return {}
        if node and all(k.startswith("#") for k in node):
            items = sorted(node.items(), key=lambda kv: int(kv[0][1:]))
            return [rebuild(v) for _, v in items]
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


def _spec_flatten(tree, prefix="") -> Dict[str, tuple]:
    """Like ``_flatten`` but records (shape, dtype) instead of values, so
    templates can be arrays, tensors or shape-and-dtype records."""
    return _walk(tree, prefix, lambda x: (tuple(x.shape), _dtype(x)),
                 ((0,), np.dtype(np.float64)))


def validate_tree(flat: Dict[str, np.ndarray], template,
                  what: str = "checkpoint") -> None:
    """Raise ValueError with an actionable per-path report when the
    flattened tree does not match the template's paths / shapes /
    dtypes."""
    want = _spec_flatten(template)
    have = {k: (tuple(v.shape), np.dtype(v.dtype)) for k, v in flat.items()}
    problems = []
    for path in sorted(set(want) - set(have)):
        problems.append(f"  missing  {path} "
                        f"(template wants {want[path][0]} {want[path][1]})")
    for path in sorted(set(have) - set(want)):
        problems.append(f"  unexpected  {path} "
                        f"(file has {have[path][0]} {have[path][1]})")
    for path in sorted(set(want) & set(have)):
        if want[path][0] != have[path][0]:
            problems.append(
                f"  shape mismatch  {path}: file {have[path][0]} "
                f"vs template {want[path][0]}")
        elif want[path][1] != have[path][1]:
            problems.append(
                f"  dtype mismatch  {path}: file {have[path][1]} "
                f"vs template {want[path][1]}")
    if problems:
        shown = problems[:12]
        if len(problems) > len(shown):
            shown.append(f"  ... and {len(problems) - len(shown)} more")
        raise ValueError(
            f"{what} does not match the provided template "
            f"({len(problems)} problem(s)):\n" + "\n".join(shown) +
            "\nLikely causes: a config change since the checkpoint was "
            "saved, or loading a different run's file.")


def save_checkpoint(path: str, state) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(state))


def load_checkpoint(path: str, template=None):
    """Load a checkpoint tree (numpy leaves); with ``template`` the file's
    paths / shapes / dtypes are validated first and a mismatch raises
    ValueError with the offending paths."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        flat = {k: z[k] for k in z.files}
    if template is not None:
        validate_tree(flat, template)
    return _unflatten(flat)


# ------------------------------------------------- elastic train state
def pack_schedule(sched: Schedule) -> Dict[str, np.ndarray]:
    """Schedule -> array dict (op table + dims) for npz storage."""
    return {"table": np.asarray(sched.table, np.int8),
            "n_layers": np.int64(sched.n_layers),
            "n_groups": np.int64(sched.n_groups)}


def unpack_schedule(d) -> Schedule:
    return Schedule(np.asarray(d["table"], np.int8),
                    int(d["n_layers"]), int(d["n_groups"]))


def pack_assignment(assignment: DeviceAssignment) -> Dict[str, np.ndarray]:
    """DeviceAssignment -> array dict; capacities round-trip when set."""
    out = {"device_of": np.asarray(assignment.device_of, np.int64),
           "costs": np.asarray(assignment.costs, np.float64),
           "n_devices": np.int64(assignment.n_devices)}
    if assignment.capacities is not None:
        out["capacities"] = np.asarray(assignment.capacities, np.float64)
    return out


def unpack_assignment(d) -> DeviceAssignment:
    caps = d.get("capacities")
    return DeviceAssignment(
        np.asarray(d["device_of"], np.int64),
        np.asarray(d["costs"], np.float64), int(d["n_devices"]),
        np.asarray(caps, np.float64) if caps is not None else None)


def save_train_state(path: str, *, step: int, params, opt_state,
                     sched: Optional[Schedule] = None,
                     assignment: Optional[DeviceAssignment] = None,
                     rng=None, extra: Optional[dict] = None) -> None:
    """Step-level checkpoint of the elastic loop: params and optimizer
    state (JAX-layout trees in canonical element order), the step
    counter, the active schedule and device assignment, the RNG key and
    any extra scalar / array loop state."""
    state = {"step": np.int64(step), "params": params,
             "opt_state": opt_state}
    if sched is not None:
        state["schedule"] = pack_schedule(sched)
    if assignment is not None:
        state["assignment"] = pack_assignment(assignment)
    if rng is not None:
        state["rng"] = np.asarray(rng)
    if extra:
        state["extra"] = {k: np.asarray(v) for k, v in extra.items()}
    save_checkpoint(path, state)


def load_train_state(path: str, params_template=None) -> dict:
    """Inverse of ``save_train_state``: ``step`` (int), ``params``,
    ``opt_state`` (numpy trees in the JAX layout) and, when saved,
    ``schedule``, ``assignment``, ``rng`` and ``extra``.
    ``params_template`` validates the params subtree."""
    state = load_checkpoint(path)
    if params_template is not None:
        validate_tree(_flatten(state["params"]), params_template,
                      what="checkpointed params")
    out = {"step": int(state["step"]), "params": state["params"],
           "opt_state": state["opt_state"]}
    if "schedule" in state:
        out["schedule"] = unpack_schedule(state["schedule"])
    if "assignment" in state:
        out["assignment"] = unpack_assignment(state["assignment"])
    if "rng" in state:
        out["rng"] = np.asarray(state["rng"])
    if "extra" in state:
        out["extra"] = {k: np.asarray(v) for k, v in state["extra"].items()}
    return out
