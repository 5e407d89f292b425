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

Device updates here (``splice_paged_layer``, ``admit_cache``,
``install_slot_rows``, ``copy_shared_page``, ``free_slot_cache``) are
**in place** on the cache's tensors: the reference returns new pytrees,
the port mutates and returns the same dict.  None of them synchronizes
with the host: table rows travel by ``device.host_to_device``, a host
scalar goes in by ``fill_`` (``t[i] = x`` on a CUDA tensor is a blocking
copy), and positions and masks are built on the device.

Pool precision (``kv_dtype``): K/V pages may be stored 8-bit with
per-page, per-kv-head fp32 scales in parallel scale pools ("ks"/"vs",
``[num_pages + 1, kv_heads]``).  Every producer re-quantizes whole pages
(``attention.rmw_quantized_pages``) and every consumer dequantizes in
the attention read, so fp32 K/V never exists at pool width.

Mamba2 layers (zamba2) and rwkv6 layers keep their O(1) recurrent
state dense, ``[slots, ...]`` per leaf (kind ``STATE``): paging
constant-size state buys nothing.  Admission copies a prefill's state
into the slot's row in place; decode replaces the leaves with the step's
new state.  An arch with no paged layer (rwkv6) has no pool groups, no
page tables and needs no pages (``blocks_needed == {}``).  Encoder and
cross-attention caches are not ported (ROADMAP A13).

``empty_batch_cache`` (``CacheSpec.init_dense_cache``) is the dense
pre-paging layout ``serve/reference.ReferenceEngine`` decodes on: one
``max_len``-or-window KV row per slot per attention layer.

Sharding: every buffer carries logical axes (``TABLE_AXES``,
``POOL_AXES``, ``SCALE_AXES``; ``structure()``), so a
``parallel/sharding.Rules`` table mapping ``BATCH`` and ``PAGES`` to a
data axis places them (``shardings(rules)``).  A rank of the sharded
engine holds ``rank_spec(n)``'s cache: its ``slots / n`` slot rows and,
per pool group, ``num_pages / n`` pages plus a trash page of its own.
Because of that trash page the port tests ``PAGES`` for divisibility on
``num_pages``; the reference tests its ``num_pages + 1`` pool rows and
replicates a pool that the port shards (ROADMAP C).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import (ATTN, MAMBA2, RWKV6, SHARED_ATTN,
                                      ModelConfig)
from repro_torch.device import host_to_device
from repro_torch.models import attention, mamba2, rwkv6
from repro_torch.models.attention import page_group_key
from repro_torch.models.transformer import map_structure
from repro_torch.parallel import sharding as sh

PAGED_KV = "paged_kv"    # block-paged KV ring (attention mixers)
STATE = "state"          # constant-size recurrent state (mamba2, rwkv6)
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
    # STATE: {leaf name: shape} at batch == slots
    state: Optional[Dict[str, Tuple[int, ...]]] = None


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
            if block.mixer in (MAMBA2, RWKV6):
                shapes = (mamba2 if block.mixer == MAMBA2
                          else rwkv6).state_shapes(cfg, slots)
                layers.append(LayerCacheSpec(STATE, state=shapes))
                continue
            if block.mixer not in (ATTN, SHARED_ATTN):
                raise NotImplementedError(
                    f"{cfg.name}: {block.mixer} caches are not ported yet "
                    "(ROADMAP A13)")
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
        paged = [ls for ls in layers if ls.kind == PAGED_KV]
        rings = sorted({ls.ring_blocks for ls in paged})
        widest = rings[-1] if rings else 1
        if num_pages is None:
            num_pages = slots * widest
        groups: List[PoolGroup] = []
        for r in rings:
            windowed = all(ls.window is not None for ls in paged
                           if ls.ring_blocks == r)
            budget = num_pages if r == widest else slots * r
            groups.append(PoolGroup(key=page_group_key(r), ring_blocks=r,
                                    num_pages=budget, windowed=windowed))
        gidx = {g.ring_blocks: i for i, g in enumerate(groups)}
        layers = [dataclasses.replace(ls, group=gidx[ls.ring_blocks])
                  if ls.kind == PAGED_KV else ls for ls in layers]
        spec = cls(cfg=cfg, slots=slots, max_len=max_len,
                   page_size=page_size, num_pages=num_pages, layers=layers,
                   groups=groups, spec_tokens=spec_tokens, kv_dtype=kv_dtype)
        for block, ls in zip(cfg.blocks, spec.layers):
            if ls.kind != PAGED_KV:
                continue
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

    POOL_AXES = (sh.PAGES, None, None, None)
    SCALE_AXES = (sh.PAGES, None)
    TABLE_AXES = (sh.BATCH, None)

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
        add fp32 scale pools "ks"/"vs"; ``dtype`` governs the dense STATE
        leaves."""
        pool_dt = self.pool_dtype if self.quantized else dtype
        layer_caches: List[Optional[Dict]] = []
        for ls in self.layers:
            if ls.kind == STATE:
                layer_caches.append({
                    k: torch.zeros(shape, dtype=dtype, device=device)
                    for k, shape in ls.state.items()})
                continue
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

    def init_dense_cache(self, device: torch.device,
                         dtype=torch.float32) -> Dict[str, Any]:
        """Zeroed dense (pre-paging) cache on ``device``: one
        ``max_len``-or-window row per slot per attention layer
        (``{"k","v"}`` shaped by ``attention.init_cache_shape``), the
        zeroed state leaves of a recurrent layer, and ``len``.
        ``ReferenceEngine`` decodes on it, as the reference's does."""
        layer_caches: List[Dict] = []
        for block, ls in zip(self.cfg.blocks, self.layers):
            if ls.kind == PAGED_KV:
                shape = attention.init_cache_shape(
                    self.cfg, self.slots,
                    min(self.max_len, block.window or self.max_len))
                layer_caches.append({
                    "k": torch.zeros(shape, dtype=dtype, device=device),
                    "v": torch.zeros(shape, dtype=dtype, device=device)})
            else:
                layer_caches.append({
                    k: torch.zeros(shape, dtype=dtype, device=device)
                    for k, shape in ls.state.items()})
        return {"layers": layer_caches,
                "len": torch.zeros((self.slots,), dtype=torch.int32,
                                   device=device)}

    # ---------------------------------------------------------- structure
    def structure(self) -> Dict[str, Any]:
        """Nested ``{name: (shape, logical_axes)}`` mirroring the paged
        cache of ``init_paged_cache`` (the reference's field for field; a
        state leaf names ``BATCH`` on its slot dim only)."""
        per_layer: List[Optional[Dict]] = []
        for ls in self.layers:
            if ls.kind == STATE:
                per_layer.append({
                    k: (shape, (sh.BATCH,) + (None,) * (len(shape) - 1))
                    for k, shape in ls.state.items()})
                continue
            group = self.groups[ls.group]
            shape = self.pool_shape_for(group)
            entry = {"pk": (shape, self.POOL_AXES),
                     "pv": (shape, self.POOL_AXES)}
            if self.quantized:
                sshape = self.scale_shape_for(group)
                entry["ks"] = (sshape, self.SCALE_AXES)
                entry["vs"] = (sshape, self.SCALE_AXES)
            per_layer.append(entry)
        return {
            "layers": per_layer,
            "page_tables": {
                g.key: ((self.slots, g.ring_blocks), self.TABLE_AXES)
                for g in self.groups},
            "len": ((self.slots,), (sh.BATCH,)),
        }

    def shardings(self, rules: sh.Rules) -> Any:
        """``rules.sharding_for`` of every leaf of ``structure()``: the
        placements on a ``DeviceMesh``, ``None`` leaves on a descriptor.
        A pool's page dim is tested for divisibility on ``num_pages``
        (each rank adds its own trash page)."""
        def place(shape, axes):
            if axes[0] == sh.PAGES:
                shape = (shape[0] - 1,) + tuple(shape[1:])
            return rules.sharding_for(axes, shape)

        return map_structure(self.structure(), place)

    def rank_spec(self, n: int) -> "CacheSpec":
        """The spec one of ``n`` data-parallel ranks holds: ``slots / n``
        slots and, per pool group, ``num_pages / n`` pages (its trash
        page is its own, ``pool_shape_for`` adds it).  ``n`` must divide
        the slots and every group's pages."""
        if n == 1:
            return self
        bad = [self.slots] + [g.num_pages for g in self.groups]
        if any(v % n for v in bad):
            raise ValueError(f"{n} ranks do not divide {self.slots} slots "
                             f"and pool pages {bad[1:]}")
        layers = [dataclasses.replace(ls, state={
            k: (shape[0] // n,) + tuple(shape[1:])
            for k, shape in ls.state.items()}) if ls.kind == STATE else ls
            for ls in self.layers]
        return dataclasses.replace(
            self, slots=self.slots // n, num_pages=self.num_pages // n,
            layers=layers,
            groups=[dataclasses.replace(g, num_pages=g.num_pages // n)
                    for g in self.groups])

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

def splice_paged_layer(pool_k: torch.Tensor, pool_v: torch.Tensor,
                       pre_k: torch.Tensor, pre_v: torch.Tensor,
                       pages_row: torch.Tensor, start: int, valid_len: int,
                       ring_blocks: int, page_size: int, trash_page: int,
                       scale_k: Optional[torch.Tensor] = None,
                       scale_v: Optional[torch.Tensor] = None) -> None:
    """Write a batch-1 prefill KV ``[1, Hkv, bucket, dh]`` into the pool,
    in place, as one token-granular scatter.

    Local token ``i`` holds position ``g = start + i`` and lands at page
    ``pages_row[(g // P) % ring_blocks]``, offset ``g % P`` — the write
    rule of decode.  ``start`` is 0 for a full prefill and the prefix
    length for a suffix prefill; it need not be page-aligned: only the
    written offsets are touched, so a copy-on-write page keeps its
    earlier tokens.  Pad tokens (``i >= valid_len``) and, when a
    windowed ring wraps inside one prefill (``bucket > ring``), every
    token that is not the newest occupant of its ring slot go to the
    trash page instead.

    With ``scale_k``/``scale_v`` (8-bit pools, [num_pages+1, Hkv]) the
    splice is page-granular: the kept tokens are grouped by the ring
    slot of their page (at most ``min(J, ring_blocks)`` of them, with
    ``J = (bucket-1)//P + 2`` the logical pages a bucket can touch), and
    each touched page is dequantized, overlaid and re-quantized with a
    fresh amax scale (``attention.rmw_quantized_pages``); a partial CoW
    page keeps its earlier tokens through the read-modify-write.  The
    pools come out as the fp32 splice's, quantized page by page.  The
    reference groups by logical page and, when ``J > ring_blocks``,
    keeps only the last ``ring_blocks`` of the ``J``, padding included,
    which can send a short prompt's first pages to the trash page
    (ROADMAP C)."""
    dev = pool_k.device
    k = pre_k[0].transpose(0, 1)          # [bucket, Hkv, dh]
    v = pre_v[0].transpose(0, 1)
    bucket = k.shape[0]
    idx = torch.arange(bucket, device=dev)
    g = start + idx
    keep = idx < valid_len
    ring = ring_blocks * page_size
    if bucket > ring:     # only wrap-capable shapes pay the mask
        keep = keep & (g >= start + valid_len - ring)
    off = torch.remainder(g, page_size)
    rows = pages_row.long()
    if scale_k is not None:
        n = min((bucket - 1) // page_size + 2, ring_blocks)
        base = start // page_size
        jtok = torch.div(g, page_size, rounding_mode="floor") - base
        # kept tokens hold distinct ring positions, so each (slot, offset)
        # gets at most one; the others land in the spare row n
        jg = torch.where(keep, torch.remainder(jtok, n), n)
        wrote = torch.zeros((n + 1, page_size), dtype=torch.bool, device=dev)
        wrote[jg, off] = keep
        wrote = wrote[:n]
        shape = (n + 1, page_size) + tuple(k.shape[1:])
        nk = torch.zeros(shape, dtype=torch.float32, device=dev)
        nv = torch.zeros(shape, dtype=torch.float32, device=dev)
        nk[jg, off] = k.float()
        nv[jg, off] = v.float()
        nk, nv = nk[:n], nv[:n]
        lp = base + torch.arange(n, device=dev)
        phys = torch.where(wrote.any(1),
                           rows[torch.remainder(lp, ring_blocks)], trash_page)
        attention.rmw_quantized_pages(pool_k, scale_k, phys, nk, wrote)
        attention.rmw_quantized_pages(pool_v, scale_v, phys, nv, wrote)
        return
    lb = torch.remainder(torch.div(g, page_size, rounding_mode="floor"),
                         ring_blocks)
    phys = torch.where(keep, rows[lb], trash_page)
    pool_k[phys, off] = k.to(pool_k.dtype)
    pool_v[phys, off] = v.to(pool_v.dtype)


def _install_rows(cache: Dict, slot: int,
                  rows: Dict[str, np.ndarray]) -> None:
    for key, table in cache["page_tables"].items():
        table[slot] = host_to_device(np.asarray(rows[key], np.int32),
                                     table.device)


def splice_prefill(spec: CacheSpec, cache: Dict, one_cache: Dict,
                   start: int, valid: int,
                   rows: Dict[str, np.ndarray]) -> None:
    """Splice the first ``valid`` tokens of a batch-1 prefill cache into
    every layer's pool, in place, through the page rows ``rows`` (one per
    pool group) from position ``start``; the slot's table and ``len``
    are left as they are.  An overlong prompt's intermediate segments
    take this alone; its final segment goes through :func:`admit_cache`.
    Segments exist only for sharing-capable (attention-only) stacks, so
    a STATE layer here is an error."""
    for ls, big, small in zip(spec.layers, cache["layers"],
                              one_cache["layers"]):
        if ls.kind != PAGED_KV:
            raise ValueError(
                f"a prompt segment reached a {ls.kind} layer; recurrent "
                "state cannot be spliced from a segment")
        _splice_kv_layer(spec, ls, big, small, rows, start, valid)


def _splice_kv_layer(spec: CacheSpec, ls: LayerCacheSpec, big: Dict,
                     small: Dict, rows: Dict[str, np.ndarray], start: int,
                     valid: int) -> None:
    """One paged layer's splice through its group's page row."""
    group = spec.groups[ls.group]
    row = host_to_device(np.asarray(rows[group.key], np.int32),
                         big["pk"].device)
    splice_paged_layer(big["pk"], big["pv"], small["k"], small["v"],
                       row, start, valid, ls.ring_blocks, spec.page_size,
                       group.trash_page, scale_k=big.get("ks"),
                       scale_v=big.get("vs"))


def admit_cache(spec: CacheSpec, cache: Dict, one_cache: Dict, slot: int,
                start: int, plen: int, rows: Dict[str, np.ndarray]) -> Dict:
    """Admission of the two-executable path, in place: splice a batch-1
    prefill cache into ``slot`` from position ``start`` (0 for a full
    prefill, the prefix length for a suffix prefill or a final segment),
    install the slot's page-table rows (one per pool group; reserved
    pages padded with the trash id) and set its ``len`` to ``plen``.
    Only the ``plen - start`` real tokens are written: the prefill's
    bucket padding goes to the trash page.  The reference pads every
    batch of admissions to a fixed count with disabled entries, and
    every prefill's KV to the largest bucket, so that one executable
    serves them; the eager port splices the real admissions' own buckets,
    which leaves the pools and tables the same — except on 8-bit pools
    where the span is wider than the ring: there the reference's
    quantized splice sends the prompt's first pages to the trash page
    (ROADMAP C) and the port's keeps them (:func:`splice_paged_layer`).
    A STATE layer's batch-1 leaves are copied into row ``slot`` of its
    dense leaves (the reference's ``_splice_state_leaf``): a ``copy_``
    into a row, no host synchronization."""
    for ls, big, small in zip(spec.layers, cache["layers"],
                              one_cache["layers"]):
        if ls.kind == STATE:
            for key, leaf in big.items():
                leaf[slot:slot + 1].copy_(small[key])
        else:
            _splice_kv_layer(spec, ls, big, small, rows, start, plen - start)
    _install_rows(cache, slot, rows)
    cache["len"][slot:slot + 1].fill_(plen)
    return cache


def install_slot_rows(spec: CacheSpec, cache: Dict, slot: int, start: int,
                      rows: Dict[str, np.ndarray]) -> Dict:
    """Table-only admission for fused chunked prefill, in place: install
    ``slot``'s page-table rows (one per group) and rewind its ``len`` to
    the prefill cursor ``start``.  No KV is written — the fused chunk
    writes prompt KV through these rows itself."""
    _install_rows(cache, slot, rows)
    cache["len"][slot:slot + 1].fill_(start)
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
        cache["page_tables"][g.key][slot].fill_(g.trash_page)
    cache["len"][slot:slot + 1].fill_(0)
    return cache


def empty_batch_cache(cfg: ModelConfig, slots: int, max_len: int,
                      device: torch.device) -> Dict[str, Any]:
    """Zeroed dense slot-batched decode cache (``ReferenceEngine``'s
    layout).  ``CacheSpec`` construction refuses cross-attention."""
    return CacheSpec.from_config(cfg, slots, max_len).init_dense_cache(
        device)
