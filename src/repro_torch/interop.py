"""Weight carry-over from the JAX package's param trees into the port.

``params_from_jax(tree)`` takes the tree of ``repro.models.transformer.
init_model`` with its leaves as numpy arrays (``jax.tree.map(np.asarray,
params)``) and returns a state dict for ``repro_torch.models.transformer.
Transformer.load_state_dict``. Leaf names and layouts are the same in both
packages, so the mapping only unstacks the layers: the JAX tree stacks the
layers of each pattern position over cycles (``cycles[j]`` has a leading
``n_cycles`` dim) and keeps the remainder in ``rest``; cycle ``c``,
position ``j`` becomes flat layer ``c*P + j``, remainder layer ``i`` becomes
``n_cycles*P + i``. ``unembed`` and a frontend arch's ``frontend_proj``
cross as they are. Every block's leaves cross the same way, an attention
block's (``attn.wq`` ...) as an SSD block's (``ssd.w_in``, ``conv_w``,
``conv_b``, ``A_log``, ``dt_bias``, ``D``, ``norm_scale``, ``w_out``;
mamba2-130m stacks its 24 layers in one pattern cycle) and an MoE FFN's
(``moe.router`` [d, E], ``moe.w_up`` / ``moe.w_gate`` [E, d, F],
``moe.w_down`` [E, F, d] and the ``moe.shared_*`` leaves, in JAX's
layouts). Tests use it so
both packages compute with the same weights; the serving path never does.

``lora_from_jax(lora, cfg)`` carries the JAX package's LoRA adapters
(``repro.core.lora.init_lora``: ``{"cycles/<j>/attn/wq": {"a": [n_cycles,
in, r], "b": [n_cycles, r, out]}, "rest/<i>/attn/wq": {"a": [in, r], ...}}``,
numpy leaves) into the port's ``{"layers.<l>.attn.wq": {"a", "b"}}`` with
the same cycle and remainder rule; a target's other leading dims stay
(``moe.w_up``'s adapters are [E, in, r] / [E, r, out], one per expert).

``params_to_jax(state, cfg)`` is the inverse of ``params_from_jax``: a
state dict (or ``dict(model.named_parameters())``) to the JAX tree, flat
layer ``c*P + j`` restacked into ``cycles[j]`` at index ``c`` and layer
``n_cycles*P + i`` into ``rest[i]``, numpy leaves (tensors are copied to
the host). ``opt_state_to_jax`` / ``opt_state_from_jax`` map an optimizer
state the same way: its params-shaped subtrees (``m`` / ``v``, ``mu``)
cross as parameters do, the step counter as a JAX int32 scalar. The
checkpoints of ``train/checkpoints.py`` store these trees, so either
package reads the other's files.

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


def _arrays_from_jax(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX tree's leaves by the port's flat names, as numpy views of
    the tree's arrays (a stacked leaf's cycle is a slice of it)."""
    state: Dict[str, np.ndarray] = {}
    for key in ("embed", "final_norm"):
        for name, a in _leaves(key, tree[key]):
            state[name] = a
    for key in ("unembed", "frontend_proj"):
        if key in tree:
            state[key] = np.asarray(tree[key])
    cycles = tree.get("cycles", [])
    P = len(cycles)
    n_cycles = 0
    for j, block in enumerate(cycles):
        for name, a in _leaves("", block):
            n_cycles = a.shape[0]
            for c in range(n_cycles):
                state[f"layers.{c * P + j}.{name}"] = a[c]
    for i, block in enumerate(tree.get("rest", [])):
        for name, a in _leaves("", block):
            state[f"layers.{n_cycles * P + i}.{name}"] = a
    return state


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {n: torch.from_numpy(a.copy())
            for n, a in _arrays_from_jax(tree).items()}


def _nest(tree: Dict[str, Any], path, value):
    *head, last = path
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def params_to_jax(state: Dict[str, Any], cfg) -> Dict[str, Any]:
    """Flat-name parameters -> the JAX package's tree (numpy leaves);
    ``cfg`` gives the pattern length P and the number of cycles. Each
    cycle's tensor is copied (from the device, for a CUDA tensor) straight
    into its slice of the stacked host array."""
    P = len(cfg.block_pattern)
    n_cycles = cfg.n_layers // P
    tree: Dict[str, Any] = {}
    stacks: Dict[tuple, list] = {}
    rest = [dict() for _ in range(cfg.n_layers - n_cycles * P)]
    for name, t in state.items():
        parts = name.split(".")
        if parts[0] != "layers":
            _nest(tree, parts, _host(t))
            continue
        layer, path = int(parts[1]), tuple(parts[2:])
        if layer < n_cycles * P:
            c, j = divmod(layer, P)
            stacks.setdefault((j, path), [None] * n_cycles)[c] = t
        else:
            _nest(rest[layer - n_cycles * P], path, _host(t))
    if n_cycles > 0:
        cycles = [dict() for _ in range(P)]
        for (j, path), parts in stacks.items():
            first = torch.as_tensor(parts[0])
            out = torch.empty((n_cycles,) + tuple(first.shape),
                              dtype=first.dtype)
            with torch.no_grad():
                for c, t in enumerate(parts):
                    out[c].copy_(torch.as_tensor(t))
            _nest(cycles[j], path, out.numpy())
        tree["cycles"] = cycles
    tree["rest"] = rest
    return tree


def opt_state_to_jax(state: Dict[str, Any], cfg) -> Dict[str, Any]:
    """An optimizer state (``optim.optimizers``: name -> tensor moments and
    an int ``step``) -> the JAX package's state tree."""
    return {k: np.int32(v) if k == "step" else params_to_jax(v, cfg)
            for k, v in state.items()}


def opt_state_from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of ``opt_state_to_jax``: host tensors and an int
    step."""
    return {k: int(np.asarray(v)) if k == "step" else params_from_jax(v)
            for k, v in tree.items()}


def lora_from_jax(lora: Dict[str, Any], cfg) -> Dict[str, Dict[str,
                                                         torch.Tensor]]:
    """Adapters keyed by the port's flat names; ``cfg`` (the model's
    ``ModelConfig``) gives the pattern length P and the number of cycles.
    The tensors are new leaves that require grad."""
    P = len(cfg.block_pattern)
    n_cycles = cfg.n_layers // P
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for path, ab in lora.items():
        group, idx, *rest = path.split("/")
        name = ".".join(rest)
        if group == "cycles":
            for c in range(n_cycles):
                out[f"layers.{c * P + int(idx)}.{name}"] = {
                    k: torch.from_numpy(np.asarray(ab[k])[c].copy())
                    .requires_grad_() for k in ("a", "b")}
        elif group == "rest":
            out[f"layers.{n_cycles * P + int(idx)}.{name}"] = {
                k: torch.from_numpy(np.asarray(ab[k]).copy())
                .requires_grad_() for k in ("a", "b")}
        else:
            raise ValueError(f"unexpected LoRA path {path!r}")
    return out


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
