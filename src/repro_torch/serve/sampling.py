"""On-device token sampling and slot bookkeeping for the serving chunks
(counterpart of the non-speculative half of ``repro/serve/sampling.py``).

Everything here stays on the device with no host synchronization:
greedy vs. sampled is chosen per slot by a ``temperature`` vector (0 ==
greedy) through ``torch.where``.  Randomness comes from an explicit
``torch.Generator``; sampled tokens are a Gumbel-max draw (exactly a
categorical sample, with no device-to-host check the way
``torch.multinomial`` has).  Torch's Philox stream is not JAX's
threefry, so sampled tokens match the reference in distribution only;
greedy tokens match exactly.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def sample(logits: torch.Tensor, gen: torch.Generator, *,
           temperature: torch.Tensor, top_k: int = 0) -> torch.Tensor:
    """Next tokens from ``logits`` [B, V] -> [B] int32.  ``temperature``
    [B] float32, 0 selects argmax for that row; ``top_k`` 0 disables the
    top-k filter."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    safe_t = torch.where(temperature > 0.0, temperature,
                         torch.ones_like(temperature))[:, None]
    if top_k and top_k < logits.shape[-1]:
        vals, idx = torch.topk(logits, top_k, dim=-1)
    else:
        vals, idx = logits, None
    u = torch.rand(vals.shape, generator=gen, device=vals.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    draw = torch.argmax(vals / safe_t + gumbel, dim=-1)
    if idx is not None:
        draw = torch.gather(idx, 1, draw[:, None])[:, 0]
    return torch.where(temperature > 0.0, draw.to(torch.int32), greedy)


def make_slot_state(slots: int, device: torch.device,
                    prompt_cap: int = 0) -> Dict[str, torch.Tensor]:
    """Device-side per-slot bookkeeping of the serving chunks.

    tokens:  last token fed/emitted per slot (decode input)
    out_len: generated tokens so far
    max_new: generation budget per slot
    eos:     per-slot EOS id, -1 for none
    active:  slot is serving a live request
    temp:    per-slot sampling temperature (0 == greedy)

    ``prompt_cap > 0`` (the fused chunked-prefill engine) adds
    ``prompt`` [slots, prompt_cap], the slot's full prompt, fed to the
    fused chunk a budgeted slice at a time, and ``plen``, its length;
    the prefill cursor is the cache ``len``.  The two-executable engine
    prefills outside the chunk and passes 0, as the reference does."""
    def zi():
        return torch.zeros((slots,), dtype=torch.int32, device=device)

    state = {
        "tokens": zi(),
        "out_len": zi(),
        "max_new": zi(),
        "eos": torch.full((slots,), -1, dtype=torch.int32, device=device),
        "active": torch.zeros((slots,), dtype=torch.bool, device=device),
        "temp": torch.zeros((slots,), dtype=torch.float32, device=device),
    }
    if prompt_cap > 0:
        state["prompt"] = torch.zeros((slots, prompt_cap), dtype=torch.int32,
                                      device=device)
        state["plen"] = zi()
    return state


def decode_update(state: Dict[str, torch.Tensor], nxt: torch.Tensor,
                  commit: Optional[torch.Tensor] = None
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One step of slot bookkeeping.  ``nxt`` [B] are freshly sampled
    tokens; returns ``(state', emitted)`` where ``emitted`` is ``nxt`` for
    committing slots and -1 elsewhere.  ``commit`` [B] narrows which
    slots take the token (default: every active slot) — the fused chunk
    passes ``active & (decoding | prefill just completed)``."""
    active = state["active"]
    if commit is None:
        commit = active
    out_len = state["out_len"] + commit.to(torch.int32)
    hit_eos = commit & (nxt == state["eos"])
    exhausted = out_len >= state["max_new"]
    done = commit & (hit_eos | exhausted)
    tokens = torch.where(commit, nxt, state["tokens"])
    emitted = torch.where(commit, nxt, torch.full_like(nxt, -1))
    new_state = dict(state, tokens=tokens, out_len=out_len,
                     active=active & ~done)
    return new_state, emitted
