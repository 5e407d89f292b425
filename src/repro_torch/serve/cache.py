"""Decode-cache subsystem of the port: ``CacheSpec`` + block-paged KV
pools in fp32, int8 or fp8_e4m3 (counterpart of ``repro/serve/cache.py``).

Attention layers keep keys and values in block-paged pools grouped by
logical ring width (``ceil(min(max_len, window) / page_size)`` pages):
each group owns a pool ``[group.num_pages + 1, page_size, kv_heads,
head_dim]``, an independent page budget and a per-slot page table
``[slots, ring_blocks]``.  The last pool row of each group is the trash
page: unreserved table entries point at it, so stray writes land there.
Physical page ids are leased host-side by ``serve/scheduler``; the
fused decode chunk only indexes the tables.

Device updates here (``install_slot_rows``, ``copy_shared_page``,
``free_slot_cache``) are **in place** on the cache's tensors: the
reference returns new pytrees, the port mutates and returns the same
dict.

Pool precision (``kv_dtype``): K/V pages may be stored 8-bit with
per-page, per-kv-head fp32 scales in parallel scale pools ("ks"/"vs",
``[num_pages + 1, kv_heads]``).  Every producer re-quantizes whole pages
(``attention.rmw_quantized_pages``) and every consumer dequantizes in
the attention read, so fp32 K/V never exists at pool width.  Layers
with recurrent state (mamba2/rwkv6) are ROADMAP A13.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ATTN, SHARED_ATTN, ModelConfig
from repro_torch.models import attention
from repro_torch.models.attention import page_group_key

PAGED_KV = "paged_kv"    # block-paged KV ring (attention mixers)
KV_DTYPES = ("fp32", "int8", "fp8_e4m3")


def kv_pool_dtype(kv_dtype: str) -> torch.dtype:
    """torch dtype the K/V pools are stored in for ``kv_dtype``."""
    if kv_dtype == "int8":
        return torch.int8
    if kv_dtype == "fp8_e4m3":
        return torch.float8_e4m3fn
    return torch.float32


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class PoolGroup:
    """One independently-budgeted page pool shared by every paged layer
    with the same logical ring width."""

    key: str            # "ring{R}"
    ring_blocks: int    # page-table width (pages per slot)
    num_pages: int      # pool budget (physical pages, excl. trash)
    windowed: bool      # True when every member layer is sliding-window

    @property
    def trash_page(self) -> int:
        return self.num_pages


@dataclasses.dataclass(frozen=True)
class LayerCacheSpec:
    """Cache layout of one decoder layer."""

    kind: str
    ring_blocks: int = 0
    window: Optional[int] = None
    group: int = -1     # index into CacheSpec.groups


@dataclasses.dataclass
class CacheSpec:
    """Shapes and kinds of a slot-batched paged decode cache, derived per
    layer from ``ModelConfig``."""

    cfg: ModelConfig
    slots: int
    max_len: int
    page_size: int
    num_pages: int
    layers: List[Optional[LayerCacheSpec]]
    groups: List[PoolGroup]
    spec_tokens: int = 0
    kv_dtype: str = "fp32"

    @classmethod
    def from_config(cls, cfg: ModelConfig, slots: int, max_len: int, *,
                    page_size: int = 8, num_pages: Optional[int] = None,
                    spec_tokens: int = 0,
                    kv_dtype: str = "fp32") -> "CacheSpec":
        if cfg.cross_attention:
            raise ValueError(
                f"{cfg.name}: cross-attention caches are not slot-batched "
                "decode caches; the serving cache is decoder-only")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
        if page_size < 1 or page_size & (page_size - 1):
            raise ValueError(f"page_size must be a power of two >= 1, got "
                             f"{page_size}")
        layers: List[Optional[LayerCacheSpec]] = []
        for block in cfg.blocks:
            if block.mixer not in (ATTN, SHARED_ATTN):
                raise NotImplementedError(
                    f"{cfg.name}: {block.mixer} state caches are not ported "
                    "yet (ROADMAP A13)")
            cap = min(max_len, block.window or max_len)
            if block.window is not None and spec_tokens:
                cap = min(max_len, block.window + spec_tokens)
            if page_size > cap:
                raise ValueError(
                    f"page_size={page_size} exceeds a paged layer's ring "
                    f"width {cap} (min(max_len={max_len}, "
                    f"window={block.window}))")
            layers.append(LayerCacheSpec(
                PAGED_KV, ring_blocks=_ceil_div(cap, page_size),
                window=block.window))
        rings = sorted({ls.ring_blocks for ls in layers})
        widest = rings[-1] if rings else 1
        if num_pages is None:
            num_pages = slots * widest
        groups: List[PoolGroup] = []
        for r in rings:
            windowed = all(ls.window is not None for ls in layers
                           if ls.ring_blocks == r)
            budget = num_pages if r == widest else slots * r
            groups.append(PoolGroup(key=page_group_key(r), ring_blocks=r,
                                    num_pages=budget, windowed=windowed))
        gidx = {g.ring_blocks: i for i, g in enumerate(groups)}
        layers = [dataclasses.replace(ls, group=gidx[ls.ring_blocks])
                  for ls in layers]
        spec = cls(cfg=cfg, slots=slots, max_len=max_len,
                   page_size=page_size, num_pages=num_pages, layers=layers,
                   groups=groups, spec_tokens=spec_tokens, kv_dtype=kv_dtype)
        for block, ls in zip(cfg.blocks, spec.layers):
            derived = attention.paged_ring_blocks(
                block.window, spec.max_blocks, page_size, spec_tokens)
            if derived != ls.ring_blocks:
                raise RuntimeError(
                    f"ring width mismatch: {derived} != {ls.ring_blocks}")
        return spec

    # --------------------------------------------------------- properties
    @property
    def has_paged(self) -> bool:
        return any(ls is not None and ls.kind == PAGED_KV
                   for ls in self.layers)

    @property
    def max_blocks(self) -> int:
        widths = [ls.ring_blocks for ls in self.layers
                  if ls is not None and ls.kind == PAGED_KV]
        return max(widths) if widths else 1

    def group_of(self, key: str) -> PoolGroup:
        for g in self.groups:
            if g.key == key:
                return g
        raise KeyError(key)

    @property
    def widest_group(self) -> PoolGroup:
        return max(self.groups, key=lambda g: g.ring_blocks)

    @property
    def share_group_key(self) -> Optional[str]:
        """Pool group eligible for cross-request prefix sharing (a single
        full-attention group, no frontend, no shared blocks), or None."""
        if not self.has_paged or self.cfg.frontend \
                or self.cfg.num_shared_groups:
            return None
        for ls in self.layers:
            if ls is None or ls.kind != PAGED_KV or ls.window is not None:
                return None
        return self.groups[0].key

    @property
    def prefix_sharing_capable(self) -> bool:
        return self.share_group_key is not None

    @property
    def trash_page(self) -> int:
        return self.widest_group.trash_page

    @property
    def quantized(self) -> bool:
        """True when K/V pages are stored 8-bit with a parallel scale pool."""
        return self.kv_dtype != "fp32"

    @property
    def pool_dtype(self) -> torch.dtype:
        return kv_pool_dtype(self.kv_dtype)

    @property
    def kv_dtype_bytes(self) -> int:
        """Bytes per stored pool element (scales accounted separately)."""
        return 1 if self.quantized else 4

    def pool_shape_for(self, group: PoolGroup) -> Tuple[int, int, int, int]:
        return (group.num_pages + 1, self.page_size,
                self.cfg.num_kv_heads, self.cfg.resolved_head_dim)

    def scale_shape_for(self, group: PoolGroup) -> Tuple[int, int]:
        """Per-page, per-kv-head scale pool parallel to the page pool."""
        return (group.num_pages + 1, self.cfg.num_kv_heads)

    def blocks_needed(self, plen: int, max_new: int) -> Dict[str, int]:
        """Worst-case page-table entries a request ever touches, per pool
        group (reserved up-front at admission)."""
        if not self.has_paged:
            return {}
        blocks = _ceil_div(max(plen + max_new, 1), self.page_size)
        return {g.key: min(blocks, g.ring_blocks) for g in self.groups}

    # -------------------------------------------------------------- init
    def init_paged_cache(self, device: torch.device,
                         dtype=torch.float32) -> Dict[str, Any]:
        """Zeroed paged cache on ``device``.  Page-table entries start at
        each group's trash page, so an unadmitted slot's writes are
        discarded.  Quantized specs store the pools in ``pool_dtype`` and
        add fp32 scale pools "ks"/"vs"."""
        pool_dt = self.pool_dtype if self.quantized else dtype
        layer_caches: List[Optional[Dict]] = []
        for ls in self.layers:
            group = self.groups[ls.group]
            shape = self.pool_shape_for(group)
            entry = {
                "pk": torch.zeros(shape, dtype=pool_dt, device=device),
                "pv": torch.zeros(shape, dtype=pool_dt, device=device)}
            if self.quantized:
                # scale floor, not zero: an unwritten page dequantizes to
                # exact zeros and never divides by zero on RMW
                sshape = self.scale_shape_for(group)
                entry["ks"] = torch.full(sshape, 1e-30, dtype=torch.float32,
                                         device=device)
                entry["vs"] = torch.full(sshape, 1e-30, dtype=torch.float32,
                                         device=device)
            layer_caches.append(entry)
        return {
            "layers": layer_caches,
            "page_tables": {
                g.key: torch.full((self.slots, g.ring_blocks), g.trash_page,
                                  dtype=torch.int32, device=device)
                for g in self.groups},
            "len": torch.zeros((self.slots,), dtype=torch.int32,
                               device=device),
        }

    # ------------------------------------------------------- memory stats
    def group_page_bytes(self, group: PoolGroup,
                         dtype_bytes: Optional[int] = None) -> int:
        """Device bytes one physical page of ``group`` costs across every
        member layer (a K and a V block per layer).  Quantized pools also
        pay the per-page fp32 scale rows (one per kv head, K and V)."""
        if dtype_bytes is None:
            dtype_bytes = self.kv_dtype_bytes
        n = sum(1 for ls in self.layers
                if ls is not None and ls.kind == PAGED_KV
                and self.groups[ls.group] is group)
        per_layer = (2 * self.page_size * self.cfg.num_kv_heads
                     * self.cfg.resolved_head_dim * dtype_bytes)
        if self.quantized and dtype_bytes == self.kv_dtype_bytes:
            per_layer += 2 * self.cfg.num_kv_heads * 4   # ks/vs scale rows
        return n * per_layer

    def dense_kv_bytes(self, dtype_bytes: int = 4) -> int:
        """What a dense per-slot ``max_len`` layout would preallocate."""
        total = 0
        for block, ls in zip(self.cfg.blocks, self.layers):
            if ls is None or ls.kind != PAGED_KV:
                continue
            ring = min(self.max_len, block.window or self.max_len)
            total += (2 * self.slots * ring * self.cfg.num_kv_heads
                      * self.cfg.resolved_head_dim * dtype_bytes)
        return total

    def paged_kv_bytes(self, dtype_bytes: Optional[int] = None) -> int:
        return sum(g.num_pages * self.group_page_bytes(g, dtype_bytes)
                   for g in self.groups)

    def total_pages(self) -> int:
        return sum(g.num_pages for g in self.groups)

    def memory_stats(self, pages_in_use: Dict[str, int],
                     live_tokens: int) -> Dict[str, Any]:
        """Paged-cache memory telemetry (the reference's schema)."""
        in_use_bytes = sum(pages_in_use.get(g.key, 0)
                           * self.group_page_bytes(g) for g in self.groups)
        dense = self.dense_kv_bytes()
        paged = self.paged_kv_bytes()
        per_tok = in_use_bytes / live_tokens if live_tokens else 0.0
        return {
            "page_size": self.page_size,
            "num_pages": self.total_pages(),
            "pages_in_use": sum(pages_in_use.values()),
            "kv_dtype": self.kv_dtype,
            "hbm_bytes_per_live_token": per_tok,
            "pool_bytes_per_live_token": per_tok,
            "dense_vs_paged_capacity_ratio": dense / paged if paged else 1.0,
            "paged_kv_bytes": paged,
            "dense_kv_bytes": dense,
            "pool_groups": {
                g.key: {"ring_blocks": g.ring_blocks,
                        "num_pages": g.num_pages,
                        "windowed": g.windowed,
                        "pages_in_use": pages_in_use.get(g.key, 0)}
                for g in self.groups},
        }


# ---------------------------------------------------------------------------
# In-place cache updates (host-issued at chunk boundaries)
# ---------------------------------------------------------------------------

def install_slot_rows(spec: CacheSpec, cache: Dict, slot: int, start: int,
                      rows: Dict[str, np.ndarray]) -> Dict:
    """Table-only admission for fused chunked prefill, in place: install
    ``slot``'s page-table rows (one per group) and rewind its ``len`` to
    the prefill cursor ``start``.  No KV is written — the fused chunk
    writes prompt KV through these rows itself."""
    for key, table in cache["page_tables"].items():
        table[slot] = torch.as_tensor(np.asarray(rows[key], np.int32),
                                      device=table.device)
    cache["len"][slot] = start
    return cache


def copy_shared_page(spec: CacheSpec, cache: Dict, group_key: str,
                     src: int, dst: int) -> Dict:
    """Copy-on-write, in place: duplicate physical page ``src`` into
    ``dst`` in every layer pool of ``group_key`` before a slot writes
    into a page it shares.  A quantized page's copy carries its scale
    rows, so it dequantizes exactly as its source."""
    for ls, big in zip(spec.layers, cache["layers"]):
        if (ls is not None and ls.kind == PAGED_KV
                and spec.groups[ls.group].key == group_key):
            for key in ("pk", "pv", "ks", "vs"):
                if key in big:
                    big[key][dst].copy_(big[key][src])
    return cache


def free_slot_cache(spec: CacheSpec, cache: Dict, slot: int) -> Dict:
    """Eviction, in place: point the freed slot's page-table rows at each
    group's trash page and zero its length, so its dead writes land on
    trash pages and its physical pages can be re-leased at once."""
    for g in spec.groups:
        cache["page_tables"][g.key][slot] = g.trash_page
    cache["len"][slot] = 0
    return cache
