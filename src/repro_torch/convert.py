"""Carry weights from the JAX package to the port.

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


def _from_flat(flat: dict) -> dict[str, torch.Tensor]:
    out = {}
    for key, arr in flat.items():
        if key.endswith(_BF16):
            out[key[: -len(_BF16)]] = _bf16(arr)
        else:
            out[key] = _to_torch(arr)
    if any(k.startswith("params/") for k in out):
        out = {k[len("params/"):]: v for k, v in out.items() if k.startswith("params/")}
    return out


def params_from_jax_numpy(tree: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """JAX params (nested tree or flat checkpoint dict) -> the port's state
    dict, on the CPU."""
    is_flat = all(isinstance(v, np.ndarray) for v in tree.values()) and \
        any("/" in k for k in tree)
    leaves = _from_flat(tree) if is_flat else \
        {path: _to_torch(np.asarray(a)) for path, a in _leaves(tree)}

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
        if t.dtype != want[k].dtype:
            raise ValueError(f"{k}: dtype {t.dtype} != declared dtype {want[k].dtype}")
    return state


def read_checkpoint(step_dir: str | Path) -> dict[str, np.ndarray]:
    """The flat arrays of a JAX checkpoint step (``<dir>/step_<n>``)."""
    with np.load(Path(step_dir) / "arrays.npz") as z:
        return dict(z)
