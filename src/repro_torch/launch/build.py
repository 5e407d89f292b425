"""Launcher glue for the dry-run: (arch, shape, setting, mesh) -> a step
and its per-device inputs on ``meta`` tensors, counted op by op
(counterpart of ``repro/launch/build.py``).

The reference builds a jit-able step with abstract sharded inputs and
lowers it for 256 or 512 devices.  The dry-run's meshes are descriptors
(``parallel/sharding.Rules.sharding_for`` returns None on them: nothing
is placed), so the port runs **one device's share** of the step on
``meta`` tensors inside an
``analysis/count.StepCounter`` (``Built.count()``, in place of
``Built.lower()``):

* **Storage** (the arguments): each parameter, optimizer moment and
  cache leaf at its per-device shard shape, every dimension divided by
  the mesh size of its ``Rules.spec_for`` entry, with the same
  divisibility fallbacks (logged in ``rules.fallbacks``).  ``fsdp`` and
  ZeRO-1 shard storage over the data axis; the optimizer state is
  ZeRO-1 sharded (``zero1_sharding_fn``), as the reference's.
* **Compute** (the step that runs): a local view of the config, each
  width divided by the mesh size its weights shard over (query heads,
  the FFN width, experts, vocab; the Mamba2 and rwkv6 inner widths,
  which those mixers read off their weights), ``d_model`` whole.  KV
  heads that the model axis replicates are stored whole but computed as
  ``max(1, Hkv * H_local / H)``, so GQA keeps its grouping.  An expert
  pool's layer routes over its local experts with the capacity of the
  whole layer (``top_k`` and the capacity factor scaled to match).
  Batch rows are divided by the data group; sequences stay whole.  A
  decode cache is computed head-parallel; its storage is the
  reference's (the sequence on the model axis).
* Training: ``train/trainer.train_step`` (forward, backward, the
  schedule, the AdamW update), with ``quantize_v`` above 50e9 parameters
  as the reference sets it; the update runs on the ZeRO-1 shards (on one
  device: on the parameters themselves, as the trainer steps them).

The reference's ``remat``, ``quantize_v`` and ``q_chunk`` options are
not taken: no caller sets them, and the flash kernel picks its own
tiles.

``PARAM_DTYPE`` is bf16, as in the reference; ``param_dtype`` overrides
it (fp32 to hold a count against the card's fp32 trainer).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.analysis import collectives as coll
from repro_torch.analysis.count import StepCounter
from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import (FFN_MOE, MAMBA2, RWKV6, ModelConfig,
                                      ShapeConfig)
from repro_torch.core import tuner
from repro_torch.launch import mesh as meshlib
from repro_torch.models import (attention, layers, mamba2, moe, rwkv6,
                                cache_structure, forward_decode,
                                forward_prefill, is_structure_leaf,
                                map_structure, model_defs)
from repro_torch.models import module as m
from repro_torch.optim import adamw
from repro_torch.optim.adamw import zero1_sharding_fn
from repro_torch.parallel import sharding as sh
from repro_torch.train.trainer import TrainerConfig, train_step

PARAM_DTYPE = torch.bfloat16
META = torch.device("meta")
SETTINGS = {
    "guideline": tuner.guideline_plan,
    "tf": tuner.tf_setting,
    "intel": tuner.intel_setting,
}


@dataclasses.dataclass
class Built:
    cfg: ModelConfig
    shape: ShapeConfig
    plan: tuner.Plan
    mesh: Any
    rules: sh.Rules
    local_cfg: ModelConfig         # the per-device compute view
    view: Dict                     # its local sizes
    step_fn: Callable              # step_fn(*abstract_args) on meta
    abstract_args: Tuple           # meta tensors at compute shapes
    argument_bytes: float          # per-device storage of the arguments
    alias_bytes: float             # arguments the step updates in place
    param_bytes: float             # per-device storage of the params
    opt_cfg: Optional[adamw.AdamWConfig] = None
    notes: str = ""

    def count(self) -> Tuple[StepCounter, Dict[str, int]]:
        """Run the step once on ``meta`` inside a ``StepCounter``: the
        counter, and the reference's memory keys (outputs: the step's
        outputs and the state it updates in place)."""
        with StepCounter() as counter:
            out = self.step_fn(*self.abstract_args)
        out_bytes = _unique_bytes(out) + self.alias_bytes
        return counter, counter.memory_stats(
            argument_bytes=self.argument_bytes, output_bytes=out_bytes,
            alias_bytes=self.alias_bytes)


# ---------------------------------------------------------------------------
# Shards and the local view
# ---------------------------------------------------------------------------

def _unique_bytes(tree) -> int:
    seen, total = set(), 0
    for t in m.tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            key = t.untyped_storage()._cdata
            if key not in seen:
                seen.add(key)
                total += t.untyped_storage().nbytes()
    return total


def _resize(defs, axis: str, size: int):
    """``defs`` with every dim of logical ``axis`` set to ``size``."""
    return m._map_tree(defs, lambda d: dataclasses.replace(d, shape=tuple(
        size if a == axis else n for a, n in zip(d.axes, d.shape))))


def _split(rules: sh.Rules, d: m.ParamDef, axis: str) -> int:
    return coll.group_of(rules, d.axes, d.shape, d.axes.index(axis))[0]


def local_view(cfg: ModelConfig, rules: sh.Rules
               ) -> Tuple[ModelConfig, Any, Dict]:
    """(the local config, its compute defs, the local sizes) of one
    device under ``rules``."""
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    h_loc = h // _split(rules, attention.attn_defs(cfg)["wq"], m.HEADS)
    hkv_loc = max(1, hkv * h_loc // h)
    emb = layers.embedding_defs(cfg)
    v_loc = cfg.vocab_size // _split(rules, emb["table"], m.VOCAB)
    moe_loc, e_loc = cfg.moe, None
    if any(b.ffn == FFN_MOE for b in cfg.blocks):
        wg = moe.moe_defs(cfg)["w_gate"]
        e = cfg.moe.num_experts
        e_loc = e // _split(rules, wg, m.EXPERT)
        f_loc = cfg.d_ff // _split(rules, wg, m.MLP)
        k_loc = min(cfg.moe.top_k, e_loc)
        moe_loc = dataclasses.replace(
            cfg.moe, num_experts=e_loc, top_k=k_loc,
            capacity_factor=cfg.moe.capacity_factor
            * (cfg.moe.top_k / e) / (k_loc / e_loc))
    else:
        f_loc = cfg.d_ff // _split(rules, layers.mlp_defs(cfg)["w_up"],
                                   m.MLP)
    local = dataclasses.replace(
        cfg, num_heads=h_loc, num_kv_heads=hkv_loc, head_dim=dh,
        d_ff=f_loc, vocab_size=v_loc, moe=moe_loc)
    defs = model_defs(local)
    view = {"heads": h_loc, "kv_heads": hkv_loc, "d_ff": f_loc,
            "vocab": v_loc, "experts": e_loc}
    for lp, block in zip(defs["layers"], cfg.blocks):
        if block.mixer == MAMBA2:
            full = mamba2.mamba2_defs(cfg)
            _d_inner, nh, _n, p = mamba2.dims(cfg)
            nh_loc = nh // _split(rules, full["wdt"], m.HEADS)
            mix = _resize(_resize(lp["mixer"], m.SSM_INNER, nh_loc * p),
                          m.HEADS, nh_loc)
            mix["norm"] = layers.rmsnorm_defs(nh_loc * p)
            lp["mixer"] = mix
            view["ssm_heads"] = nh_loc
        elif block.mixer == RWKV6:
            nh, hd = rwkv6.hdims(cfg)
            g = math.gcd(nh, _split(rules, rwkv6.time_mix_defs(cfg)["wr"],
                                    m.SSM_INNER))
            lp["mixer"] = _resize(lp["mixer"], m.SSM_INNER, nh // g * hd)
            view["wkv_heads"] = nh // g
    return local, defs, view


def _meta_tree(defs, dtype, trainable: bool) -> m.ParamTree:
    tree = m._map_tree(defs, lambda d: torch.empty(
        d.shape, dtype=d.dtype or dtype, device=META))
    return m.ParamTree(tree, trainable)


# ---------------------------------------------------------------------------
# Abstract inputs
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, shape: ShapeConfig, rules: sh.Rules,
                dtype=PARAM_DTYPE) -> Dict[str, torch.Tensor]:
    """The step's batch on ``meta`` at its per-device shape: tokens (and
    labels) [B,S] int32 with B over the data group; whisper's
    ``frames``, a frontend's ``frontend`` [B,F,d]."""
    b, s = shape.global_batch, shape.seq_len
    tok = rules.shard_shape((sh.BATCH, None), (b, s))
    out = {"tokens": torch.empty(tok, dtype=torch.int32, device=META)}
    if shape.kind == "train":
        out["labels"] = torch.empty(tok, dtype=torch.int32, device=META)
    emb = rules.shard_shape((sh.BATCH, None, None),
                            (b, cfg.frontend_len, cfg.d_model))
    if cfg.family == "audio":
        out["frames"] = torch.empty(emb, dtype=dtype, device=META)
    elif cfg.frontend:
        out["frontend"] = torch.empty(emb, dtype=dtype, device=META)
    return out


def abstract_model_params(cfg: ModelConfig, rules: sh.Rules,
                          dtype=PARAM_DTYPE, trainable: bool = False):
    """(the local view's params on ``meta``, the full defs, the local
    config, the local sizes)."""
    local, cdefs, view = local_view(cfg, rules)
    return _meta_tree(cdefs, dtype, trainable), model_defs(cfg), local, view


def storage_shapes(cfg: ModelConfig, rules: sh.Rules, defs=None):
    """(each parameter's, each optimizer moment's) per-device storage
    shape in flatten order: the param rules' shards and the ZeRO-1
    shards (``optim/adamw.zero1_sharding_fn``), the shapes that the
    sharded step's ranks hold (``parallel/sharding.place``,
    ``adamw.init``)."""
    defs = model_defs(cfg) if defs is None else defs
    zfn = zero1_sharding_fn(cfg, rules, defs)
    leaves = m.tree_leaves(defs)
    return ([rules.shard_shape(d.axes, d.shape) for d in leaves],
            [rules.local_shape(zfn(d.shape), d.shape) for d in leaves])


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------

def one_device() -> Tuple[tuner.Plan, meshlib.MeshDescriptor]:
    """A plan and a mesh of one device (every spec entry of size 1): the
    step counted on ``meta`` as one card runs it."""
    return (tuner.Plan(name="one_device", data=1, pools=1, intra=1),
            meshlib.MeshDescriptor(("data", "model"), (1, 1)))


def build(arch: Union[str, ModelConfig],
          shape_name: Union[str, ShapeConfig], *,
          setting: str = "guideline", multi_pod: bool = False,
          factored: bool = False, plan: Optional[tuner.Plan] = None,
          mesh=None,
          param_dtype=PARAM_DTYPE) -> Built:
    """``arch`` and ``shape_name`` may be a config and a shape; ``mesh``
    (a ``launch/mesh`` descriptor) overrides the plan's."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = get_shape(shape_name) if isinstance(shape_name, str) \
        else shape_name
    pods = 2 if multi_pod else 1
    if plan is None:
        plan = SETTINGS[setting](cfg, shape, pods=pods)
    if mesh is None:
        mesh = meshlib.mesh_for_plan(plan, multi_pod=multi_pod,
                                     factored=factored)
    rules = tuner.make_rules(plan, mesh)
    if shape.kind == "train":
        return _build_train(cfg, shape, plan, mesh, rules, param_dtype)
    if shape.kind == "prefill":
        return _build_prefill(cfg, shape, plan, mesh, rules, param_dtype)
    return _build_decode(cfg, shape, plan, mesh, rules, param_dtype)


def _build_train(cfg, shape, plan, mesh, rules, dtype) -> Built:
    params, defs, local, view = abstract_model_params(cfg, rules, dtype,
                                                      trainable=True)
    param_bytes = coll.shard_bytes(defs, rules, dtype)
    ocfg = adamw.AdamWConfig(quantize_v=m.param_count(defs) > 50e9)
    leaves = m.tree_leaves(params)
    zshapes = storage_shapes(cfg, rules, defs)[1]
    on_params = all(tuple(p.shape) == z for p, z in zip(leaves, zshapes))
    if on_params:          # one device: the update steps the params
        upd_params = None
        opt = adamw.init(params, ocfg)
    else:                  # ZeRO-1: the update steps each shard
        upd_params = [torch.empty(z, dtype=p.dtype, device=META)
                      for p, z in zip(leaves, zshapes)]
        opt = adamw.init(upd_params, ocfg)
    state = {"params": params, "opt": opt,
             "step": torch.zeros((), dtype=torch.int32, device=META)}
    batch = batch_specs(cfg, shape, rules, dtype)
    # the ZeRO-1 shards stand for slices of the params' storage
    state_bytes = param_bytes + _unique_bytes(opt) + 4

    def zero1_update(opt_, lr):
        """AdamW on the ZeRO-1 shards, their reduce-scattered gradients
        standing in as tensors of their shape."""
        grads = [torch.empty(u.shape, dtype=u.dtype, device=META)
                 for u in upd_params]
        return adamw.update(grads, opt_, upd_params, ocfg, lr)[2]

    def step(st, bt):
        return train_step(st, bt, local, ocfg, TrainerConfig().steps,
                          update=None if upd_params is None
                          else zero1_update)

    return Built(cfg, shape, plan, mesh, rules, local, view, step,
                 (state, batch), argument_bytes=state_bytes
                 + _unique_bytes(batch), alias_bytes=state_bytes,
                 param_bytes=param_bytes, opt_cfg=ocfg, notes=plan.notes)


def _build_prefill(cfg, shape, plan, mesh, rules, dtype) -> Built:
    params, defs, local, view = abstract_model_params(cfg, rules, dtype)
    param_bytes = coll.shard_bytes(defs, rules, dtype)
    batch = batch_specs(cfg, shape, rules, dtype)

    def prefill_step(params_, bt):
        with torch.no_grad():
            return forward_prefill(params_, local, bt)

    return Built(cfg, shape, plan, mesh, rules, local, view, prefill_step,
                 (params, batch),
                 argument_bytes=param_bytes + _unique_bytes(batch),
                 alias_bytes=0.0, param_bytes=param_bytes, notes=plan.notes)


def _build_decode(cfg, shape, plan, mesh, rules, dtype) -> Built:
    params, defs, local, view = abstract_model_params(cfg, rules, dtype)
    param_bytes = coll.shard_bytes(defs, rules, dtype)
    b, t = shape.global_batch, shape.seq_len
    b_loc = rules.shard_shape((sh.BATCH,), (b,))[0]

    def leaf_dtype(axes, shp):
        return torch.int32 if axes == (sh.BATCH,) and len(shp) == 1 \
            else dtype

    # storage: the reference's cache, each leaf at its shard shape
    stored = 0.0
    for shp, axes in m.tree_leaves(cache_structure(cfg, b, t),
                                   is_leaf=is_structure_leaf):
        stored += math.prod(rules.shard_shape(axes, shp)) \
            * leaf_dtype(axes, shp).itemsize
    # compute: the local view's cache at the device's rows
    cache = map_structure(cache_structure(local, b_loc, t), lambda shp, ax:
                          torch.empty(shp, dtype=leaf_dtype(ax, shp),
                                      device=META))
    for entry, block, lp in zip(cache["layers"], cfg.blocks,
                                m.tree_of(params)["layers"]):
        if block.mixer == MAMBA2:
            nh = lp["mixer"]["a_log"].shape[0]
            width = lp["mixer"]["wx"].shape[1] + 2 * cfg.ssm.state_dim
            entry["conv"] = torch.empty(
                (b_loc, cfg.ssm.conv_width - 1, width), dtype=dtype,
                device=META)
            entry["ssm"] = torch.empty(
                (b_loc, nh, cfg.ssm.state_dim, cfg.ssm.head_dim),
                dtype=dtype, device=META)
        elif block.mixer == RWKV6:
            hd = cfg.rwkv.head_dim
            entry["wkv"] = torch.empty(
                (b_loc, lp["mixer"]["wr"].shape[1] // hd, hd, hd),
                dtype=dtype, device=META)
    tokens = torch.empty((b_loc, 1), dtype=torch.int32, device=META)

    def decode_step(cache_, params_, tokens_):
        with torch.no_grad():
            logits, new_cache = forward_decode(params_, local, tokens_,
                                               cache_)
        return new_cache, logits

    return Built(cfg, shape, plan, mesh, rules, local, view, decode_step,
                 (cache, params, tokens),
                 argument_bytes=param_bytes + stored + _unique_bytes(tokens),
                 alias_bytes=stored, param_bytes=param_bytes,
                 notes=plan.notes)


__all__ = ["PARAM_DTYPE", "SETTINGS", "Built", "abstract_model_params",
           "batch_specs", "build", "local_view", "one_device",
           "storage_shapes", "zero1_sharding_fn"]
