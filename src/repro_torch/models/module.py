"""Parameter trees for the port: ``ParamDef`` tables, seeded init and
the weight bridge from the reference's pytrees.

A model's parameters are one ``ParamTree`` — an ``nn.Module`` whose
submodule and parameter names are the reference's pytree keys, so
``named_parameters()`` yields ``layers.0.mixer.wq``, ``embed.table``,
... and each tensor keeps the reference's layout (``wq [d,H,dh]``,
``wo [H,dh,d]``, ``head [d,V]``).  Layer code indexes it like the
reference's nested dicts (``params["layers"][0]["mixer"]["wq"]``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "fan_in"     # fan_in | zeros | ones | normal | embed | custom
    scale: float = 1.0       # extra multiplier on the init
    dtype: Optional[torch.dtype] = None   # None -> the model's param dtype
    # init="custom": (generator, shape, device) -> fp32 tensor
    custom: Optional[Callable] = None


class ParamTree(nn.Module):
    """Nested parameter container: dict nodes are ``ParamTree``s, list
    nodes ``nn.ModuleList``s, leaves frozen ``nn.Parameter``s (serving
    never trains).  ``tree["key"]`` reads a child like a dict."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, torch.Tensor):
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))
            elif isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(key, nn.ModuleList(
                    [ParamTree(v) for v in val]))
            else:
                raise TypeError(f"param tree leaf {key!r}: {type(val)}")

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(v, fn) for v in tree]
    return fn(tree)


def _init_one(d: ParamDef, gen: torch.Generator, dtype,
              device: torch.device) -> torch.Tensor:
    dtype = d.dtype or dtype
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.init == "custom":
        return d.custom(gen, d.shape, device).to(dtype)
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                    device=device)
    if d.init in ("normal", "embed"):
        std = d.scale
    elif d.init == "fan_in":
        fan_in = d.shape[0] if len(d.shape) == 1 \
            else int(np.prod(d.shape[:-1]))
        std = d.scale / max(fan_in, 1) ** 0.5
    else:
        raise ValueError(f"unknown init {d.init!r}")
    return x.mul_(std).to(dtype)


def init_params(defs, seed: int, dtype=torch.float32,
                device: DeviceLike = None) -> ParamTree:
    """Random parameters from a defs tree, drawn from one seeded
    ``torch.Generator`` on ``device`` (the card unless given).  The init
    rules are the reference's; the random bits are torch's, so the same
    seed gives other values than ``repro.models.module.init_params`` —
    parity tests carry the reference's values over with
    :func:`params_from_numpy` instead."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(tree):   # the reference's flatten order: sorted dict keys
        if isinstance(tree, dict):
            return {k: draw(tree[k]) for k in sorted(tree)}
        if isinstance(tree, (list, tuple)):
            return [draw(v) for v in tree]
        return _init_one(tree, gen, dtype, dev)

    return ParamTree(draw(defs))


def params_from_numpy(tree, device: DeviceLike = None) -> ParamTree:
    """The weight bridge: the reference's param pytree as numpy arrays
    (``jax.tree.map(np.asarray, params)``) -> the port's params, key for
    key and layout for layout (no transposes)."""
    dev = resolve_device(device)
    return ParamTree(_map_tree(
        tree, lambda a: torch.as_tensor(np.array(a)).to(dev)))


def params_to_numpy(params: nn.Module) -> Dict[str, np.ndarray]:
    """Flat ``{dotted name: array}`` view, for round-trip checks."""
    return {k: v.detach().cpu().numpy()
            for k, v in params.named_parameters()}
