"""Weight carry-over from the JAX package's param trees into the port.

``params_from_jax(tree)`` takes the tree of ``repro.models.transformer.
init_model`` with its leaves as numpy arrays (``jax.tree.map(np.asarray,
params)``) and returns a state dict for ``repro_torch.models.transformer.
Transformer.load_state_dict``. Leaf names and layouts are the same in both
packages, so the mapping only unstacks the layers: the JAX tree stacks the
layers of each pattern position over cycles (``cycles[j]`` has a leading
``n_cycles`` dim) and keeps the remainder in ``rest``; cycle ``c``,
position ``j`` becomes flat layer ``c*P + j``, remainder layer ``i`` becomes
``n_cycles*P + i``. Tests use it so both packages compute with the same
weights; the serving path never does.

``vit_params_from_jax(tree)`` does the same for ``repro.models.vit.
init_vit``'s tree (``patch_proj``, ``patch_bias``, ``cls``, ``pos``, a
``blocks`` list, ``final_norm``, ``head``): block ``i`` becomes
``blocks.i`` of ``repro_torch.models.vit.ViT``; names and layouts are kept.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


def _leaves(prefix: str, tree: Any) -> Iterator[Tuple[str, np.ndarray]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(f"{prefix}.{k}" if prefix else k, v)
    else:
        yield prefix, np.asarray(tree)


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    state: Dict[str, torch.Tensor] = {}
    for key in ("embed", "final_norm"):
        for name, a in _leaves(key, tree[key]):
            state[name] = torch.from_numpy(a.copy())
    if "unembed" in tree:
        state["unembed"] = torch.from_numpy(np.asarray(tree["unembed"]).copy())
    cycles = tree.get("cycles", [])
    P = len(cycles)
    n_cycles = 0
    for j, block in enumerate(cycles):
        for name, a in _leaves("", block):
            n_cycles = a.shape[0]
            for c in range(n_cycles):
                state[f"layers.{c * P + j}.{name}"] = torch.from_numpy(
                    a[c].copy())
    for i, block in enumerate(tree.get("rest", [])):
        for name, a in _leaves("", block):
            state[f"layers.{n_cycles * P + i}.{name}"] = torch.from_numpy(
                a.copy())
    return state


def vit_params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    state: Dict[str, torch.Tensor] = {}
    for key in ("patch_proj", "patch_bias", "cls", "pos", "head"):
        state[key] = torch.from_numpy(np.asarray(tree[key]).copy())
    for name, a in _leaves("final_norm", tree["final_norm"]):
        state[name] = torch.from_numpy(a.copy())
    for i, block in enumerate(tree["blocks"]):
        for name, a in _leaves(f"blocks.{i}", block):
            state[name] = torch.from_numpy(a.copy())
    return state
