"""Draft proposers of the speculative serving path (counterpart of
``repro/serve/spec/drafter.py``).

Both drafters are device-side functions of the slot state, free of host
synchronization, so a chunk stays sync-free with speculation on.  The
contract is::

    drafts, qprobs = drafter.propose(draft_params, cache, state, gen,
                                     top_k)

``drafts`` [B, K] int32 are proposed continuations of
``state["tokens"]``; ``qprobs`` [B, K, V] is the per-position proposal
distribution, or None for a deterministic proposer (the accept rule
then treats the proposal as a point mass).  A model drafter advances
its own draft cache (``cache["draft"]``) in place.

**NGramDrafter** (prompt-lookup decoding): finds the most recent earlier
occurrence of the last ``n`` tokens in the slot's history
(``state["hist"]``: prompt plus everything emitted) and proposes the
``K`` tokens that followed it.  No second model; a wrong draft costs
only verify work, because the accept rule rejects it.

**ModelDrafter**: a small attention-only model decoded ``K`` steps ahead
on its own *dense* per-slot KV cache.  Positions past the committed
length are overwritten by later writes, like the target's pages, so an
imperfect draft cache can only lower the acceptance rate, never change
the verified output.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.models import attention
from repro_torch.models.transformer import forward_decode
from repro_torch.serve import sampling


def ngram_propose(hist: torch.Tensor, hist_len: torch.Tensor, *, k: int,
                  n: int) -> torch.Tensor:
    """Prompt-lookup proposal: continue the most recent earlier match of
    the trailing ``n``-gram.

    hist [B, C + 1] (the last, spill column is excluded); hist_len [B]
    valid entries.  Returns drafts [B, k] int32.  With no earlier match
    the last token is repeated: a cheap fallback whose drafts simply get
    rejected."""
    h = hist[:, :-1]
    c = h.shape[1]
    dev = h.device
    hl = hist_len.long()
    gpos = hl[:, None] - n + torch.arange(n, device=dev)[None, :]
    gram = torch.gather(h, 1, torch.clamp(gpos, 0, c - 1))
    win = h.unfold(1, n, 1)              # all length-n windows [B, C-n+1, n]
    jidx = torch.arange(c - n + 1, device=dev)[None, :]
    match = (win == gram[:, None, :]).all(dim=-1)
    # an eligible start has a continuation inside the history and is not
    # the trailing gram itself
    ok = match & (jidx + n < hl[:, None]) & (gpos[:, :1] >= 0)
    # rank by USABLE continuation length first (a match right at the
    # history tail can contribute one token before running off the
    # written region), recency second
    avail = torch.clamp(hl[:, None] - (jidx + n), max=k)
    score = torch.where(ok, avail * (c + 1) + jidx, -1)
    j = torch.argmax(score, dim=1)
    found = score.amax(dim=1) >= 0
    # continuation positions past the written history wrap by the match
    # period, so a cyclic tail drafts a full K tokens
    p = torch.clamp(hl - n - j, min=1)[:, None]
    i = torch.arange(k, device=dev)[None, :]
    cpos = j[:, None] + n + i
    cpos = torch.where(cpos >= hl[:, None], j[:, None] + n + i % p, cpos)
    drafts = torch.gather(h, 1, torch.clamp(cpos, 0, c - 1))
    last = torch.gather(h, 1, torch.clamp(hl - 1, 0, c - 1)[:, None])
    return torch.where(found[:, None], drafts, last).to(torch.int32)


class NGramDrafter:
    """Model-free prompt-lookup drafter (see the module docstring)."""

    kind = "ngram"

    def __init__(self, k: int, n: int = 3):
        self.k = int(k)
        self.n = int(n)

    def propose(self, draft_params: Any, cache: Dict, state: Dict,
                gen: torch.Generator, top_k: int
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Reads the history only; params and generator are unused."""
        return ngram_propose(state["hist"], state["hist_len"], k=self.k,
                             n=self.n), None


class ModelDrafter:
    """Small-model drafter over a dense per-slot draft KV cache."""

    kind = "model"

    def __init__(self, cfg: ModelConfig, k: int, cache_tokens: int):
        bad = sorted({b.mixer for b in cfg.blocks if b.mixer != ATTN})
        if bad or cfg.frontend or cfg.cross_attention:
            raise ValueError(
                f"draft model {cfg.name} must be a plain attention-only "
                f"decoder (got {bad or 'frontend/cross-attention'})")
        self.cfg = cfg
        self.k = int(k)
        self.cache_tokens = int(cache_tokens)

    def init_cache(self, slots: int, device: torch.device) -> List[Dict]:
        """Zeroed dense draft KV: one ``cache_tokens`` row per slot per
        draft layer (a small model: paging buys nothing)."""
        shape = attention.init_cache_shape(self.cfg, slots,
                                           self.cache_tokens)
        return [{"k": torch.zeros(shape, dtype=torch.float32, device=device),
                 "v": torch.zeros(shape, dtype=torch.float32, device=device)}
                for _ in self.cfg.blocks]

    def propose(self, draft_params: Any, cache: Dict, state: Dict,
                gen: torch.Generator, top_k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``K`` sequential draft-model decode steps on the device.  Draft
        tokens are *sampled* from the draft distribution at the slot's
        temperature (greedy at 0), the proposal the accept rule needs,
        and that distribution is returned as ``qprobs``."""
        dc = {"layers": cache["draft"], "len": cache["len"]}
        tok, temp = state["tokens"], state["temp"]
        drafts, qlogits = [], []
        for _ in range(self.k):
            lg, dc = forward_decode(draft_params, self.cfg, tok[:, None], dc)
            tok = sampling.sample(lg, gen, temperature=temp, top_k=top_k)
            drafts.append(tok)
            qlogits.append(lg)
        # one more forward only to write the LAST draft's KV: a fully
        # accepted round commits through that position, and without it
        # the next round's draft steps would attend stale entries there
        forward_decode(draft_params, self.cfg, tok[:, None], dc)
        qprobs = sampling.spec_probs(torch.stack(qlogits, dim=1), temp,
                                     top_k)
        return torch.stack(drafts, dim=1), qprobs
