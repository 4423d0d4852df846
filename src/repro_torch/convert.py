"""Carry weights and optimizer state between the JAX package and the port.

``params_from_jax_numpy(tree, cfg)`` takes either

  * the JAX param pytree with its leaves as numpy arrays
    (``jax.tree.map(np.asarray, params)``), or
  * the flat ``"/"``-keyed dict that ``repro.train.checkpoint`` writes into
    ``arrays.npz`` (bf16 leaves stored as uint16 under ``<key>::bf16``; the
    ``params/`` subtree is taken and the optimizer state under ``opt/`` is
    not served),

and returns a state dict for ``Model.load``: the same weights, same dtypes
(the f32 leaves of the SSM families stay f32 beside the model dtype), with
every stacked layer axis unstacked (``layers/`` into ``layers.<i>.``,
``ssm_layers/`` into ``ssm_layers.<i>.``) and the singleton stack axis of
the hybrid's ``shared/`` block dropped.  A missing or unexpected key, a
shape or a dtype that does not match the module the config builds raises;
nothing is skipped.  So a checkpoint a JAX job wrote serves in torch: the
paper's reconfiguration across a restart, here across frameworks.

``params_to_jax_numpy(state, flat=...)`` is the inverse: every layer is
restacked on a leading axis (the hybrid's ``shared.`` block on a leading
axis of 1), giving either the nested JAX tree (bfloat16 leaves as their
uint16 bit patterns: numpy has no bfloat16; ``a.view(jnp.bfloat16)`` on the
JAX side) or the flat ``params/``-prefixed keys of ``arrays.npz``.
``opt_state_to_jax_numpy`` and ``opt_state_from_jax_numpy`` do the same for
the optimizer state ``{"count", "m", "v"}`` (Lion: no ``v``), whose JAX keys
sit under ``opt/``.  So a torch checkpoint restores in JAX too.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import nn
from repro_torch.models.api import family_of

_BF16 = "::bf16"
_STACKED = ("layers", "ssm_layers")   # leading axis: one entry per layer
_SINGLETON = ("shared",)              # leading axis of 1: one shared block


def _bf16(bits: np.ndarray) -> torch.Tensor:
    """bfloat16 from its 16-bit patterns (numpy has bf16 only through
    ml_dtypes; a checkpoint stores it as uint16)."""
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16).copy()).view(
        torch.bfloat16)


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":
        return _bf16(arr)
    return torch.from_numpy(np.ascontiguousarray(arr).copy())


def _leaves(tree, prefix: str = ""):
    """(path, array) for every leaf of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _from_flat(flat: dict, prefix: str = "params/") -> dict[str, torch.Tensor]:
    """The leaves under ``prefix`` (all of them if none is), prefix dropped."""
    if any(k.startswith(prefix) for k in flat):
        flat = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
    out = {}
    for key, arr in flat.items():
        if key.endswith(_BF16):
            out[key[: -len(_BF16)]] = _bf16(arr)
        else:
            out[key] = _to_torch(arr)
    return out


def _is_flat(tree: dict) -> bool:
    return all(isinstance(v, np.ndarray) for v in tree.values()) and \
        any("/" in k for k in tree)


def params_from_jax_numpy(tree: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """JAX params (nested tree or flat checkpoint dict) -> the port's state
    dict, on the CPU."""
    leaves = _from_flat(tree) if _is_flat(tree) else \
        {path: _to_torch(np.asarray(a)) for path, a in _leaves(tree)}
    return _checked(_unstack(leaves, cfg), cfg, check_dtype=True)


def _unstack(leaves: dict[str, torch.Tensor], cfg: ModelConfig) -> dict[str, torch.Tensor]:
    state: dict[str, torch.Tensor] = {}
    for path, t in leaves.items():
        head, _, rest = path.partition("/")
        name = rest.replace("/", ".")
        if head in _STACKED and rest:
            if t.shape[0] != cfg.n_layers:
                raise ValueError(f"{path}: leading axis {t.shape[0]} != n_layers "
                                 f"{cfg.n_layers}")
            for i in range(cfg.n_layers):
                state[f"{head}.{i}.{name}"] = t[i].clone()
        elif head in _SINGLETON and rest:
            if t.shape[0] != 1:
                raise ValueError(f"{path}: leading axis {t.shape[0]} != 1")
            state[f"{head}.{name}"] = t[0].clone()
        else:
            state[path.replace("/", ".")] = t
    return state


def _checked(state: dict[str, torch.Tensor], cfg: ModelConfig,
             check_dtype: bool) -> dict[str, torch.Tensor]:
    module = family_of(cfg).module
    want = module(cfg, "meta", nn.dtype_of(cfg.dtype)).state_dict()
    missing = sorted(set(want) - set(state))
    extra = sorted(set(state) - set(want))
    if missing or extra:
        raise KeyError(f"{cfg.name}: params do not match the port's model; "
                       f"missing {missing[:8]}, unexpected {extra[:8]}")
    for k, t in state.items():
        if tuple(t.shape) != tuple(want[k].shape):
            raise ValueError(f"{k}: shape {tuple(t.shape)} != {tuple(want[k].shape)}")
        if check_dtype and t.dtype != want[k].dtype:
            raise ValueError(f"{k}: dtype {t.dtype} != declared dtype {want[k].dtype}")
    return state


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    # A copy even on the CPU, where ``.cpu()`` would hand back the live
    # tensor: an async checkpoint write must not see the next step's updates.
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _stack(state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The port's "."-keyed state -> "/"-keyed leaves with layers restacked."""
    out: dict[str, torch.Tensor] = {}
    stacks: dict[str, dict[int, torch.Tensor]] = {}
    for name, t in state.items():
        head, _, rest = name.partition(".")
        if head in _STACKED:
            i, _, leaf = rest.partition(".")
            stacks.setdefault(f"{head}/{leaf.replace('.', '/')}", {})[int(i)] = t
        elif head in _SINGLETON:
            out[f"{head}/{rest.replace('.', '/')}"] = t[None]
        else:
            out[name.replace(".", "/")] = t
    for key, by_layer in stacks.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise KeyError(f"{key}: layers {sorted(by_layer)} are not 0..n-1")
        out[key] = torch.stack([by_layer[i].detach() for i in range(len(by_layer))])
    return out


def _export(leaves: dict[str, torch.Tensor], prefix: str, flat: bool) -> dict:
    if flat:
        return {f"{prefix}/{k}" + (_BF16 if t.dtype == torch.bfloat16 else ""): _to_numpy(t)
                for k, t in leaves.items()}
    tree: dict = {}
    for key, t in leaves.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = _to_numpy(t)
    return tree


def params_to_jax_numpy(state: dict[str, torch.Tensor], *, flat: bool = False) -> dict:
    """The port's state dict -> the JAX param tree (``flat=False``) or the
    flat ``params/...`` keys of a checkpoint's ``arrays.npz`` (``flat=True``,
    bfloat16 under ``<key>::bf16``), numpy leaves on the host."""
    return _export(_stack(state), "params", flat)


def opt_state_to_jax_numpy(opt_state: dict, *, flat: bool = False) -> dict:
    """The port's optimizer state -> the JAX ``{"count", "m"[, "v"]}`` tree,
    or its flat ``opt/...`` checkpoint keys; ``count`` as an int32 scalar."""
    count = np.asarray(opt_state["count"], np.int32)
    parts = [k for k in ("m", "v") if k in opt_state]
    if flat:
        out = {"opt/count": count}
        for k in parts:
            out.update(_export(_stack(opt_state[k]), f"opt/{k}", flat=True))
        return out
    return {"count": count, **{k: _export(_stack(opt_state[k]), k, flat=False)
                               for k in parts}}


def opt_state_from_jax_numpy(tree: dict, cfg: ModelConfig) -> dict:
    """A JAX optimizer state (its tree, or a checkpoint's flat dict holding
    ``opt/...`` keys) -> ``{"count": int, "m": state dict[, "v": ...]}`` on
    the CPU, each moment named and shaped like the parameter it belongs to."""
    if _is_flat(tree):
        count = tree["opt/count"]
        parts = {k: _from_flat(tree, f"opt/{k}/") for k in ("m", "v")
                 if any(key.startswith(f"opt/{k}/") for key in tree)}
    else:
        count = tree["count"]
        parts = {k: {path: _to_torch(np.asarray(a)) for path, a in _leaves(tree[k])}
                 for k in ("m", "v") if k in tree}
    out = {"count": int(np.asarray(count))}
    for k, leaves in parts.items():
        out[k] = _checked(_unstack(leaves, cfg), cfg, check_dtype=False)
    return out


def read_checkpoint(step_dir: str | Path) -> dict[str, np.ndarray]:
    """The flat arrays of a JAX checkpoint step (``<dir>/step_<n>``)."""
    with np.load(Path(step_dir) / "arrays.npz") as z:
        return dict(z)
