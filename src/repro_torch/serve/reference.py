"""Reference (pre-fast-path) serving engine of the port (counterpart of
``repro/serve/reference.py``), kept as the measurement baseline of
``benchmarks/fig14_dispatch_overhead.py`` and as the oracle of the
engine-equivalence tests.

It keeps the anti-pattern the paper's §2.2.3 / Fig. 14 analysis warns
about, on purpose: every admission prefills at the exact prompt length,
every decode step reads the slots' tokens back to the host with one
``int()`` per slot, and the cache splice is a Python loop of copies.
``host_syncs`` counts the device-to-host reads at the reference's three
places (the spliced length, the first token, each decode step).

Eager torch has no trace cache, so ``prefill_compiles`` and
``decode_compiles`` count the distinct input shapes each callable has
run: what the reference's ``jit`` caches hold, one executable each.
A patch-frontend arch (pixtral) prefills with zero stub embeddings in
its first ``frontend_len`` positions, as the reference does; a
cross-attention arch (whisper) is refused, as there.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import forward_decode, forward_prefill
from repro_torch.serve.cache import empty_batch_cache
from repro_torch.serve.scheduler import Request

__all__ = ["ReferenceEngine", "Request"]


class ReferenceEngine:
    """Slot-based continuous batching with per-token host synchronization
    over the dense per-slot cache (``serve/cache.empty_batch_cache``).
    ``device`` holds params and cache (default: the card)."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 256, greedy: bool = True,
                 device: DeviceLike = None):
        if cfg.cross_attention:
            raise NotImplementedError(
                "Engine serves decoder-only archs; whisper runs through "
                "forward_prefill, prepare_decode_cache and forward_decode")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.greedy = greedy
        self._prefill_shapes = set()
        self._decode_shapes = set()
        self._slot_req: List[Optional[Request]] = [None] * slots
        self.cache = empty_batch_cache(cfg, slots, max_len, self.device)
        # a patch-frontend arch's prefill: zero stub embeddings first
        self._frontend = None
        if cfg.frontend:
            self._frontend = torch.zeros(
                (1, cfg.frontend_len, cfg.d_model), dtype=torch.float32,
                device=self.device)
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.steps = 0
        self.host_syncs = 0

    # ------------------------------------------------------------ serving
    def submit(self, req: Request) -> None:
        if self.cfg.frontend and len(req.prompt) < self.cfg.frontend_len:
            raise ValueError(
                f"{self.cfg.name}: a {len(req.prompt)}-token prompt is "
                f"shorter than the {self.cfg.frontend_len}-position "
                "frontend")
        self.queue.append(req)

    @property
    def prefill_compiles(self) -> int:
        return len(self._prefill_shapes)

    @property
    def decode_compiles(self) -> int:
        return len(self._decode_shapes)

    def _prefill(self, tokens: torch.Tensor):
        self._prefill_shapes.add(tuple(tokens.shape))
        batch = {"tokens": tokens}
        if self._frontend is not None:
            batch["frontend"] = self._frontend
        return forward_prefill(self.params, self.cfg, batch)

    def _decode(self, tokens: torch.Tensor, cache):
        self._decode_shapes.add(tuple(tokens.shape))
        return forward_decode(self.params, self.cfg, tokens, cache)

    def _splice(self, slot: int, one_cache) -> None:
        """Copy a batch-1 prefill cache into slot ``slot``."""
        plen = int(one_cache["len"][0])
        self.host_syncs += 1
        for big, small in zip(self.cache["layers"], one_cache["layers"]):
            for key, b in big.items():
                s = small[key]
                if s.shape != b[slot:slot + 1].shape:
                    size = b.shape[-2]
                    if s.shape[-2] > size:
                        # windowed ring buffer: keep the last ``size``
                        # tokens and roll so token t sits at slot t % size
                        # (the decode write rule), keeping ring overwrites
                        # oldest-first
                        s = torch.roll(s[..., -size:, :], plen % size,
                                       dims=-2)
                    else:
                        s = F.pad(s, (0, 0, 0, size - s.shape[-2]))
                b[slot:slot + 1] = s.to(b.dtype)
        self.cache["len"][slot] = plen

    def _admit(self) -> None:
        for slot in range(self.slots):
            if self._slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            prompt = torch.tensor([req.prompt], dtype=torch.int32,
                                  device=self.device)
            logits, one_cache = self._prefill(prompt)
            tok = self._sample(logits)[0]
            req.out_tokens.append(int(tok))
            self.host_syncs += 1
            self._slot_req[slot] = req
            self._splice(slot, one_cache)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        if self.greedy:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        raise NotImplementedError

    def step(self) -> None:
        self._admit()
        live = [i for i, r in enumerate(self._slot_req) if r is not None]
        if not live:
            return
        tokens = np.zeros((self.slots, 1), np.int32)
        for i in live:
            tokens[i, 0] = self._slot_req[i].out_tokens[-1]
        logits, self.cache = self._decode(
            torch.as_tensor(tokens).to(self.device), self.cache)
        nxt = self._sample(logits)
        self.host_syncs += 1
        self.steps += 1
        for i in live:
            req = self._slot_req[i]
            req.out_tokens.append(int(nxt[i]))
            hit_eos = (req.eos_id is not None
                       and req.out_tokens[-1] == req.eos_id)
            if len(req.out_tokens) >= req.max_new_tokens or hit_eos:
                req.done = True
                self.finished.append(req)
                self._slot_req[i] = None
                self.cache["len"][i] = 0

    def run(self, max_steps: int = 1000) -> List[Request]:
        while (self.queue or any(r is not None for r in self._slot_req)) \
                and self.steps < max_steps:
            self.step()
        return self.finished
