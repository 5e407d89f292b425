"""OpGraph IR: the computational-graph view the paper's guideline reads
(counterpart of ``repro/core/graph.py``, the same graphs op for op).

Paper §8: *"The average width of a model is the floor of the ratio of the
total number of (heavy) operators divided by the maximum number of layers.
A heavy operator is a compute-intensive or embedding operator."*

Every ``ModelConfig`` compiles to an ``OpGraph`` of heavy operators (matmul-
class ops, embedding lookups, SSM scans) with dataflow edges.  Light ops
(norms, activations, reshapes, masks) are excluded, per the paper.  From the
graph we derive:

  * ``max_width``   — widest antichain by depth level (paper Fig. 4 table);
  * ``avg_width``   — ``floor(num_heavy_ops / depth)`` (paper §8);
  * per-level structure used by the fig04/fig06 benchmarks.

Training graphs are widened x2 (independent gradient + weight-update ops per
layer, paper §4.1) unless the batch is large (the paper's observed
grad/weight-sum imbalance at large batch, §4.1/§7.2).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import (ATTN, FFN_DENSE, FFN_MOE, MAMBA2,
                                      RWKV6, SHARED_ATTN, ModelConfig)

LARGE_BATCH = 128  # paper §4.1: training widening stops paying off here


@dataclasses.dataclass
class OpNode:
    uid: int
    kind: str                  # matmul | embedding | scan | attention | conv
    name: str
    flops: float               # per-token flops estimate (relative weights)
    deps: Tuple[int, ...] = ()
    level: int = -1            # filled by _levelize


@dataclasses.dataclass
class OpGraph:
    nodes: List[OpNode]
    name: str = ""

    # ------------------------------------------------------------- metrics
    def _levelize(self) -> None:
        lv: Dict[int, int] = {}
        for nd in self.nodes:  # nodes are topo-ordered by construction
            lv[nd.uid] = (max((lv[d] for d in nd.deps), default=-1) + 1)
            nd.level = lv[nd.uid]

    @property
    def depth(self) -> int:
        self._levelize()
        return max((nd.level for nd in self.nodes), default=-1) + 1

    @property
    def num_heavy_ops(self) -> int:
        return len(self.nodes)

    @property
    def max_width(self) -> int:
        self._levelize()
        counts: Dict[int, int] = {}
        for nd in self.nodes:
            counts[nd.level] = counts.get(nd.level, 0) + 1
        return max(counts.values(), default=0)

    @property
    def avg_width(self) -> int:
        """Paper §8 definition."""
        d = self.depth
        return max(1, self.num_heavy_ops // max(d, 1))

    def level_sizes(self) -> List[int]:
        self._levelize()
        out = [0] * self.depth
        for nd in self.nodes:
            out[nd.level] += 1
        return out

    def level_flops(self) -> List[List[float]]:
        """Per level, the flops of each parallel op (fig06 imbalance study)."""
        self._levelize()
        out: List[List[float]] = [[] for _ in range(self.depth)]
        for nd in self.nodes:
            out[nd.level].append(nd.flops)
        return out


class _Builder:
    def __init__(self, name: str):
        self.nodes: List[OpNode] = []
        self.name = name

    def add(self, kind: str, name: str, flops: float, deps=()) -> int:
        uid = len(self.nodes)
        self.nodes.append(OpNode(uid, kind, name, flops,
                                 tuple(d for d in deps if d is not None)))
        return uid

    def graph(self) -> OpGraph:
        g = OpGraph(self.nodes, self.name)
        g._levelize()
        return g


def _attn_ops(b: _Builder, cfg: ModelConfig, li: int, prev: Optional[int],
              tag: str = "") -> int:
    d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    dh = cfg.resolved_head_dim
    q = b.add("matmul", f"L{li}{tag}.wq", 2 * d * h * dh, (prev,))
    k = b.add("matmul", f"L{li}{tag}.wk", 2 * d * kv * dh, (prev,))
    v = b.add("matmul", f"L{li}{tag}.wv", 2 * d * kv * dh, (prev,))
    s = b.add("attention", f"L{li}{tag}.qk", 2 * h * dh, (q, k))
    pv = b.add("attention", f"L{li}{tag}.pv", 2 * h * dh, (s, v))
    return b.add("matmul", f"L{li}{tag}.wo", 2 * h * dh * d, (pv,))


def _mlp_ops(b: _Builder, cfg: ModelConfig, li: int, prev: Optional[int],
             tag: str = "") -> int:
    d, ff = cfg.d_model, cfg.d_ff
    g = b.add("matmul", f"L{li}{tag}.w_gate", 2 * d * ff, (prev,))
    u = b.add("matmul", f"L{li}{tag}.w_up", 2 * d * ff, (prev,))
    return b.add("matmul", f"L{li}{tag}.w_down", 2 * ff * d, (g, u))


def _moe_ops(b: _Builder, cfg: ModelConfig, li: int, prev: Optional[int]) -> int:
    d, ff = cfg.d_model, cfg.d_ff
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    r = b.add("matmul", f"L{li}.router", 2 * d * e, (prev,))
    outs = []
    frac = k / e  # expected per-expert token share of the layer's tokens
    for ei in range(e):
        g = b.add("matmul", f"L{li}.e{ei}.gate", 2 * d * ff * frac, (r,))
        u = b.add("matmul", f"L{li}.e{ei}.up", 2 * d * ff * frac, (r,))
        o = b.add("matmul", f"L{li}.e{ei}.down", 2 * ff * d * frac, (g, u))
        outs.append(o)
    return b.add("matmul", f"L{li}.combine", 2 * d * k, tuple(outs))


def _mamba_ops(b: _Builder, cfg: ModelConfig, li: int, prev: Optional[int]) -> int:
    d = cfg.d_model
    di = cfg.ssm.expand * d
    n = cfg.ssm.state_dim
    z = b.add("matmul", f"L{li}.wz", 2 * d * di, (prev,))
    x = b.add("matmul", f"L{li}.wx", 2 * d * di, (prev,))
    c = b.add("conv", f"L{li}.conv", 2 * cfg.ssm.conv_width * di, (x,))
    s = b.add("scan", f"L{li}.ssd", 2 * di * (cfg.ssm.chunk + 2 * n), (c,))
    return b.add("matmul", f"L{li}.out", 2 * di * d, (s, z))


def _rwkv_ops(b: _Builder, cfg: ModelConfig, li: int, prev: Optional[int]) -> int:
    d = cfg.d_model
    rr = b.add("matmul", f"L{li}.wr", 2 * d * d, (prev,))
    kk = b.add("matmul", f"L{li}.wk", 2 * d * d, (prev,))
    vv = b.add("matmul", f"L{li}.wv", 2 * d * d, (prev,))
    gg = b.add("matmul", f"L{li}.wg", 2 * d * d, (prev,))
    s = b.add("scan", f"L{li}.wkv", 2 * d * (cfg.rwkv.chunk + cfg.rwkv.head_dim),
              (rr, kk, vv))
    o = b.add("matmul", f"L{li}.wo", 2 * d * d, (s, gg))
    # channel mix
    ck = b.add("matmul", f"L{li}.cmix_k", 2 * d * cfg.d_ff, (o,))
    cr = b.add("matmul", f"L{li}.cmix_r", 2 * d * d, (o,))
    return b.add("matmul", f"L{li}.cmix_v", 2 * cfg.d_ff * d, (ck, cr))


def build_graph(cfg: ModelConfig, *, training: bool = False,
                global_batch: int = 1) -> OpGraph:
    b = _Builder(cfg.name)
    prev = b.add("embedding", "embed", 0.0)
    if cfg.enc_layers:
        # encoder runs concurrently with nothing at train time but its output
        # is a dependency of every decoder cross-attention; in *batched
        # serving* the encoder of request i+1 overlaps the decoder of request
        # i, which is why whisper's serving width is 2.
        eprev = b.add("embedding", "enc_embed", 0.0)
        for li in range(cfg.enc_layers):
            a = _attn_ops(b, cfg, li, eprev, tag="enc")
            eprev = _mlp_ops(b, cfg, li, a, tag="enc_mlp")
    for li, block in enumerate(cfg.blocks):
        if block.mixer in (ATTN, SHARED_ATTN):
            prev = _attn_ops(b, cfg, li, prev,
                             tag=".shared" if block.mixer == SHARED_ATTN else "")
        elif block.mixer == MAMBA2:
            prev = _mamba_ops(b, cfg, li, prev)
        elif block.mixer == RWKV6:
            prev = _rwkv_ops(b, cfg, li, prev)
            continue  # rwkv ffn is inside _rwkv_ops
        if block.ffn == FFN_DENSE:
            prev = _mlp_ops(b, cfg, li, prev)
        elif block.ffn == FFN_MOE:
            prev = _moe_ops(b, cfg, li, prev)
    b.add("matmul", "lm_head", 2 * cfg.d_model * cfg.vocab_size, (prev,))
    g = b.graph()
    if training and global_batch < LARGE_BATCH:
        g = widen_for_training(g)
    return g


def widen_for_training(g: OpGraph) -> OpGraph:
    """Paper §4.1: gradient + weight-update ops double the parallel heavy
    ops of each level."""
    b = _Builder(g.name + "+train")
    for nd in g.nodes:
        b.add(nd.kind, nd.name, nd.flops, nd.deps)
    base = len(g.nodes)
    for nd in g.nodes:  # mirrored gradient ops, same dependency skeleton
        b.add(nd.kind, nd.name + ".grad", nd.flops,
              tuple(d + base for d in nd.deps))
    return b.graph()
