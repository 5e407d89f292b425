"""The collectives of a step under a mesh plan, priced by ring formulas:
the port's counterpart of ``repro/analysis/hlo.py``.

The reference reads its collectives off the compiled SPMD program
(``compiled.as_text()``, parsed for all-gather, all-reduce,
reduce-scatter, all-to-all and collective-permute).  The port lowers no
HLO, so it has no parser: ``step_collectives(cfg, shape, plan, rules)``
lists the collectives the plan implies, each priced per device by the
reference's ring formulas (``_wire_bytes``, word for word):

    all-reduce       2 * S * (n-1)/n
    all-gather           S * (n-1)/n        (S = gathered output)
    reduce-scatter       S * (n-1)          (S = scattered output)
    all-to-all           S * (n-1)/n
    collective-permute   S

A group's size is the mesh size of the spec entry that ``rules.spec_for``
gives the weight (or activation) that implies it, divisibility fallbacks
included, so a head count that does not divide the model axis makes no
tensor-parallel traffic.  T is the tokens a device holds (its batch rows
times the sequence; one row a sequence when decoding), D the model
width, activations (``ACT_BYTES``) and weights (``PARAM_DTYPE``) in
bf16, as the build's:

* tensor parallel, per mixer and FFN whose weights shard on the model
  axis (attention heads, the MLP, the Mamba2 / rwkv6 inner width): an
  all-reduce of the block's output [T, D], or under ``seq_shard`` an
  all-gather of its input and a reduce-scatter of its output; training
  repeats each in the backward (all-reduce for all-reduce, the
  reduce-scatter and all-gather swapped);
* expert pools (experts sharded): an all-to-all for the dispatch and one
  for the combine, T k D a device (T over the model axis under
  ``seq_shard``), as ``core/cost_model.estimate`` prices them; experts
  replicated with their FFN width sharded: an all-gather of the
  dispatch buffer [T k c, D] and an all-reduce of the combine buffer;
* context parallelism (``cp``): each attention layer all-gathers its K
  and V [B, S, Hkv dh] over the sequence's axis (twice in training);
* a vocab-sharded table: the lookup's all-reduce [T, D]; a vocab-sharded
  head: three fp32 all-reduces [T] for the softmax (max, sum, the
  label's logit) and, training, the backward's all-reduce [T, D]; when
  serving, an all-gather of the last position's logits [B, V] fp32;
* data parallel, training: the gradients' reduce-scatter and the updated
  parameters' all-gather (ZeRO-1, the build's optimizer state); under
  ``fsdp`` (and ``cp``, whose
  weights shard over every axis) the parameters are all-gathered layer
  by layer in the forward (and again in the backward), then the
  gradients reduce-scattered;
* the pod axis: under ``pod_mode`` ``"dp"`` it joins the data group,
  under ``"mp"`` the model group, as the rules place it.

Every entry's ``line`` names what it moves, its payload and its group.
"""

from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import (ATTN, FFN_DENSE, FFN_MOE, FFN_NONE,
                                      FFN_RWKV, MAMBA2, RWKV6, SHARED_ATTN,
                                      ModelConfig, ShapeConfig)
from repro_torch.models import module as m
from repro_torch.parallel import sharding as sh

ACT_BYTES = 2                 # bf16 activations
PARAM_DTYPE = torch.bfloat16  # the build's parameters


@dataclasses.dataclass
class Collective:
    op: str
    bytes_payload: float     # per-device payload, as the reference's
    group_size: int
    wire_bytes: float        # ring-model bytes on the wire per device
    line: str = ""


def _wire_bytes(op: str, payload: float, n: int) -> float:
    if n <= 1:
        return payload if op == "collective-permute" else 0.0
    if op == "all-reduce":
        return 2.0 * payload * (n - 1) / n
    if op == "all-gather":
        return payload * (n - 1) / n
    if op == "reduce-scatter":
        return payload * (n - 1)
    if op == "all-to-all":
        return payload * (n - 1) / n
    if op == "collective-permute":
        return payload
    return 0.0


def summarize(colls: List[Collective]) -> Dict:
    by_op: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "payload_bytes": 0.0, "wire_bytes": 0.0})
    for c in colls:
        e = by_op[c.op]
        e["count"] += 1
        e["payload_bytes"] += c.bytes_payload
        e["wire_bytes"] += c.wire_bytes
    total_wire = sum(e["wire_bytes"] for e in by_op.values())
    return {"by_op": dict(by_op), "total_wire_bytes": total_wire,
            "num_collectives": len(colls)}


def collective_bytes(colls: List[Collective]) -> float:
    return summarize(colls)["total_wire_bytes"]


def collective(op: str, payload: float, n: int, what: str) -> Collective:
    return Collective(op, float(payload), int(n),
                      _wire_bytes(op, float(payload), int(n)), what)


# ---------------------------------------------------------------------------
# The plan's collectives
# ---------------------------------------------------------------------------

def group_of(rules: sh.Rules, axes: Sequence[Optional[str]],
             dims: Sequence[int], i: int) -> Tuple[int, str]:
    """(mesh size, mesh axes) of dim ``i``'s entry in the spec that
    ``rules`` gives a tensor of these logical axes and dims."""
    spec = rules.spec_for(axes, dims)
    entry = spec[i] if i < len(spec) else None
    if entry is None:
        return 1, "-"
    name = ",".join(entry) if isinstance(entry, tuple) else entry
    return rules.mesh_size(entry), name


def _weight_group(rules, d: m.ParamDef, axis: str) -> Tuple[int, str]:
    return group_of(rules, d.axes, d.shape, d.axes.index(axis))


def shard_bytes(defs, rules: sh.Rules, dtype=torch.bfloat16) -> float:
    """Per-device bytes of a defs tree's shards, each leaf in its
    ``ParamDef`` dtype or ``dtype``."""
    return float(sum(math.prod(rules.shard_shape(d.axes, d.shape))
                     * (d.dtype or dtype).itemsize
                     for d in m.tree_leaves(defs)))


def step_collectives(cfg: ModelConfig, shape: ShapeConfig, plan,
                     rules: sh.Rules) -> List[Collective]:
    """The collectives of one step of ``shape`` (train, prefill or
    decode) under ``plan`` and its ``rules``, per device."""
    from repro_torch.models import attention, layers, mamba2, moe, rwkv6
    from repro_torch.models.transformer import model_defs

    train = shape.kind == "train"
    b = shape.global_batch
    s = 1 if shape.kind == "decode" else shape.seq_len
    dp, dp_ax = group_of(rules, (sh.BATCH,), (b,), 0)
    b_loc = b // dp
    t = b_loc * s
    d = cfg.d_model
    act = t * d * ACT_BYTES
    seq_shard = bool(rules.table.get(sh.SEQ)) and not plan.cp \
        and shape.kind != "decode"
    out: List[Collective] = []

    def tp(g: int, ax: str, what: str) -> None:
        """One tensor-parallel block output (and its backward)."""
        if g <= 1:
            return
        tag = f"{what}: [T={t}, D={d}] over {ax} ({g})"
        if seq_shard:
            out.append(collective("all-gather", act, g, tag + " in"))
            out.append(collective("reduce-scatter", act / g, g, tag + " out"))
            if train:
                out.append(collective("all-gather", act, g, tag + " bwd"))
                out.append(collective("reduce-scatter", act / g, g,
                                      tag + " bwd in"))
        else:
            out.append(collective("all-reduce", act, g, tag))
            if train:
                out.append(collective("all-reduce", act, g, tag + " bwd"))

    def attn(what: str, kv_len: int) -> None:
        wq = attention.attn_defs(cfg)["wq"]
        if plan.cp:
            g, ax = group_of(rules, (sh.BATCH, sh.SEQ), (b, shape.seq_len),
                             1)
            if g > 1:
                kv = b_loc * kv_len * cfg.num_kv_heads \
                    * cfg.resolved_head_dim * ACT_BYTES
                for name in ("K", "V"):
                    for rep in range(2 if train else 1):
                        out.append(collective(
                            "all-gather", kv, g,
                            f"{what} cp {name}{' bwd' if rep else ''}: "
                            f"[B={b_loc}, S={kv_len}] over {ax} ({g})"))
            return
        tp(*_weight_group(rules, wq, m.HEADS), what)

    def ffn_moe(what: str) -> None:
        defs = moe.moe_defs(cfg)["w_gate"]
        ep, ep_ax = _weight_group(rules, defs, m.EXPERT)
        tpe, tpe_ax = _weight_group(rules, defs, m.MLP)
        k = cfg.moe.top_k
        if ep > 1:
            tok = t / (ep * tpe if seq_shard else 1)
            payload = tok * k * d * ACT_BYTES
            for name in ("dispatch", "combine"):
                for rep in range(2 if train else 1):
                    out.append(collective(
                        "all-to-all", payload, ep,
                        f"{what} {name}{' bwd' if rep else ''}: "
                        f"[{tok:g} x k={k}, D={d}] over {ep_ax} ({ep})"))
        if tpe > 1:
            buf = t * k * cfg.moe.capacity_factor * d * ACT_BYTES
            tag = f"{what}: [T={t} x k={k} x c, D={d}] over {tpe_ax} ({tpe})"
            out.append(collective("all-gather", buf, tpe, tag + " dispatch"))
            out.append(collective("all-reduce", buf, tpe, tag + " combine"))
            if train:
                out.append(collective("reduce-scatter", buf / tpe, tpe,
                                      tag + " dispatch bwd"))
                out.append(collective("all-reduce", buf, tpe,
                                      tag + " combine bwd"))

    mlp_w = layers.mlp_defs(cfg)["w_up"]
    if cfg.enc_layers:
        for i in range(cfg.enc_layers):
            attn(f"encoder {i} attn", cfg.frontend_len)
            tp(*_weight_group(rules, mlp_w, m.MLP), f"encoder {i} mlp")
    for i, block in enumerate(cfg.blocks):
        name = f"layer {i}"
        kv_len = shape.seq_len
        if block.mixer in (ATTN, SHARED_ATTN):
            attn(f"{name} attn", kv_len)
        elif block.mixer == MAMBA2:
            tp(*_weight_group(rules, mamba2.mamba2_defs(cfg)["wx"],
                              m.SSM_INNER), f"{name} mamba2")
        elif block.mixer == RWKV6:
            tp(*_weight_group(rules, rwkv6.time_mix_defs(cfg)["wr"],
                              m.SSM_INNER), f"{name} rwkv6 time-mix")
        if cfg.cross_attention:
            attn(f"{name} cross-attn", cfg.frontend_len)
        if block.mixer == SHARED_ATTN or block.ffn == FFN_DENSE:
            tp(*_weight_group(rules, mlp_w, m.MLP), f"{name} mlp")
        elif block.ffn == FFN_MOE:
            ffn_moe(f"{name} moe")
        elif block.ffn == FFN_RWKV:
            tp(*_weight_group(rules, rwkv6.channel_mix_defs(cfg)["wk"],
                              m.MLP), f"{name} rwkv6 channel-mix")
        elif block.ffn != FFN_NONE:
            raise ValueError(f"unknown ffn {block.ffn!r}")

    emb = layers.embedding_defs(cfg)
    gv, v_ax = _weight_group(rules, emb["table"], m.VOCAB)
    if gv > 1:
        out.append(collective("all-reduce", act, gv,
                              f"embedding lookup: [T={t}, D={d}] over "
                              f"{v_ax} ({gv})"))
    head = emb.get("head", emb["table"])
    gh, h_ax = _weight_group(rules, head, m.VOCAB)
    if gh > 1:
        if train:
            for what in ("max", "sum", "label logit"):
                out.append(collective("all-reduce", t * 4, gh,
                                      f"softmax {what}: [T={t}] fp32 over "
                                      f"{h_ax} ({gh})"))
            out.append(collective("all-reduce", act, gh,
                                  f"head bwd: [T={t}, D={d}] over {h_ax} "
                                  f"({gh})"))
        else:
            out.append(collective("all-gather", b_loc * cfg.vocab_size * 4,
                                  gh, f"logits: [B={b_loc}, V="
                                      f"{cfg.vocab_size}] fp32 over {h_ax} "
                                      f"({gh})"))

    # parameters over the data axis (all axes under cp): the payload is
    # every weight's shard on the other axes
    emb_rule = rules.table.get(m.EMBED)
    if emb_rule is not None or (dp > 1 and train):
        nofsdp = dataclasses.replace(rules, table={**rules.table,
                                                   m.EMBED: None},
                                     fallbacks=[])
        grads = shard_bytes(model_defs(cfg), nofsdp, PARAM_DTYPE)
        tag = f"over {dp_ax} ({dp})"
        if emb_rule is not None:
            what = "cp" if plan.cp else "fsdp"
            n = rules.mesh_size(emb_rule)
            ax = ",".join(emb_rule) if isinstance(emb_rule, tuple) \
                else emb_rule
            for rep in range(2 if train else 1):
                out.append(collective(
                    "all-gather", grads, n,
                    f"{what} params{' bwd' if rep else ''}: {grads:.0f} "
                    f"bytes over {ax} ({n})"))
            if train:
                out.append(collective("reduce-scatter", grads / n, n,
                                      f"{what} grads over {ax} ({n})"))
        else:
            out.append(collective("reduce-scatter", grads / dp, dp,
                                  f"zero-1 grads {tag}"))
            out.append(collective("all-gather", grads, dp,
                                  f"zero-1 params {tag}"))
    return out


__all__ = ["Collective", "collective", "collective_bytes", "group_of",
           "shard_bytes", "step_collectives", "summarize"]
