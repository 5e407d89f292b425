"""On-device token sampling and slot bookkeeping for the serving chunks,
the speculative accept/reject sampler included (counterpart of
``repro/serve/sampling.py``).

Everything here stays on the device with no host synchronization:
greedy vs. sampled is chosen per slot by a ``temperature`` vector (0 ==
greedy) through ``torch.where``.  Randomness comes from an explicit
``torch.Generator``; every categorical draw is a Gumbel-max draw
(exactly a categorical sample, with no device-to-host check the way
``torch.multinomial`` has).  Torch's Philox stream is not JAX's
threefry, so sampled tokens match the reference in distribution only;
greedy tokens match exactly.

The speculative half (``spec_probs`` / ``spec_accept`` /
``spec_update``) is standard rejection sampling over ``K`` drafted
tokens verified by one multi-row target pass: draft ``d_i`` is accepted
with probability ``min(1, p(d_i)/q(d_i))``, the first rejection
resamples from the residual ``norm(max(p - q, 0))``, and a fully
accepted draft earns a bonus token from the last row.  At temperature 0
``p`` and ``q`` are point masses, so the rule is "accept while the
draft equals the target's argmax, then emit the argmax": the output is
token-identical to plain greedy decoding.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def _categorical(scores: torch.Tensor, gen: torch.Generator
                 ) -> torch.Tensor:
    """One categorical draw per row of unnormalized log-probabilities
    ``scores`` [..., V] (Gumbel-max): int64 indices [...]."""
    u = torch.rand(scores.shape, generator=gen, device=scores.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(scores + gumbel, dim=-1)


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
    draw = _categorical(vals / safe_t, gen)
    if idx is not None:
        draw = torch.gather(idx, 1, draw[:, None])[:, 0]
    return torch.where(temperature > 0.0, draw.to(torch.int32), greedy)


def make_slot_state(slots: int, device: torch.device,
                    prompt_cap: int = 0, *, hist_cap: int = 0,
                    spec: bool = False,
                    prefill_budget: int = 0) -> Dict[str, torch.Tensor]:
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
    prefills outside the chunk and passes 0, as the reference does.
    ``prefill_budget > 0`` adds ``pbudget`` [slots], each slot's cap on
    prompt tokens per fused micro-step (clamped into ``[1, S]`` by the
    chunk), which the SLO policy lowers at chunk boundaries: a value,
    never a shape.

    ``spec`` adds the speculative counters (0-d int32): ``spec_steps``
    (slot-steps that drafted), ``spec_drafted``, ``spec_accepted`` and
    ``spec_emitted``.  ``hist_cap > 0`` (the n-gram drafter only) adds
    ``hist`` [slots, hist_cap + 1], each slot's token history (prompt
    and emitted tokens: the lookup corpus; the last column is a spill
    cell that absorbs masked and overflowing writes and is never read),
    and ``hist_len``, its valid entries."""
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
    if spec or hist_cap:
        for c in ("spec_steps", "spec_drafted", "spec_accepted",
                  "spec_emitted"):
            state[c] = torch.zeros((), dtype=torch.int32, device=device)
    if hist_cap:
        state["hist"] = torch.zeros((slots, hist_cap + 1), dtype=torch.int32,
                                    device=device)
        state["hist_len"] = zi()
    if prompt_cap > 0:
        state["prompt"] = torch.zeros((slots, prompt_cap), dtype=torch.int32,
                                      device=device)
        state["plen"] = zi()
    if prefill_budget:
        state["pbudget"] = torch.full((slots,), prefill_budget,
                                      dtype=torch.int32, device=device)
    return state


def decode_update(state: Dict[str, torch.Tensor], nxt: torch.Tensor,
                  commit: Optional[torch.Tensor] = None
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One step of slot bookkeeping.  ``nxt`` [B] are freshly sampled
    tokens; returns ``(state', emitted)`` where ``emitted`` is ``nxt`` for
    committing slots and -1 elsewhere.  ``commit`` [B] narrows which
    slots take the token (default: every active slot) — the fused chunk
    passes ``active & (decoding | prefill just completed)``.  With a
    drafting history the committed token is appended to it."""
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
    if "hist" in state:    # n-gram corpus: append the committed token
        hist, hist_len = state["hist"], state["hist_len"]
        cap = hist.shape[1] - 1
        rows = torch.arange(hist.shape[0], device=hist.device)
        pos = torch.where(commit, torch.clamp(hist_len, max=cap), cap)
        new_state["hist"] = hist.index_put(
            (rows, pos.long()),
            torch.clamp(torch.where(commit, nxt, 0), min=0).to(hist.dtype))
        new_state["hist_len"] = hist_len + commit.to(torch.int32)
    return new_state, emitted


# ---------------------------------------------------------------------------
# Speculative decoding: accept/reject sampler + multi-token bookkeeping
# ---------------------------------------------------------------------------

def spec_probs(logits: torch.Tensor, temperature: torch.Tensor,
               top_k: int = 0) -> torch.Tensor:
    """The distributions ``sample`` draws from, per position: logits
    [B,S,V] -> probs [B,S,V] fp32.  Greedy rows (temperature 0) are a
    one-hot point mass at the argmax; sampled rows are
    ``softmax(logits / T)`` over the ``top_k``-filtered support."""
    logits = logits.float()
    v = logits.shape[-1]
    safe_t = torch.where(temperature > 0.0, temperature,
                         torch.ones_like(temperature))[:, None, None]
    z = logits / safe_t
    if top_k and top_k < v:
        kth = torch.topk(z, top_k, dim=-1).values[..., -1:]
        z = torch.where(z >= kth, z, float("-inf"))
    p = torch.softmax(z, dim=-1)
    greedy = torch.zeros_like(p).scatter_(
        -1, torch.argmax(logits, dim=-1, keepdim=True), 1.0)
    return torch.where(temperature[:, None, None] > 0.0, p, greedy)


def spec_accept(logits: torch.Tensor, drafts: torch.Tensor,
                qprobs: Optional[torch.Tensor], temperature: torch.Tensor,
                top_k: int, gen: torch.Generator
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rejection-sample ``K`` drafted tokens against the target's verify
    logits.

    logits [B,K+1,V]: row ``i`` is the target's distribution of the token
    after verify input ``i`` (input 0 is the committed current token,
    input ``i >= 1`` draft ``i``).  drafts [B,K] int32; qprobs [B,K,V] the
    drafter's proposal distributions, or None for a deterministic
    (point-mass) drafter such as the n-gram lookup.  Returns ``(cand
    [B,K+1] int32, n_acc [B] int32)``: ``cand[:, j]`` for ``j < n_acc``
    is accepted draft ``j+1``, ``cand[:, n_acc]`` the resampled
    correction (or the bonus token when all ``K`` were accepted);
    entries past ``n_acc`` are meaningless (``spec_update`` masks them)."""
    b, s, v = logits.shape
    k = s - 1
    p = spec_probs(logits, temperature, top_k)               # [B,K+1,V]
    d = drafts.long()[..., None]
    if qprobs is None:
        q = torch.zeros((b, k, v), dtype=torch.float32,
                        device=logits.device).scatter_(-1, d, 1.0)
    else:
        q = qprobs.float()
    pd = torch.gather(p[:, :k], 2, d)[..., 0]
    qd = torch.gather(q, 2, d)[..., 0]
    u = torch.rand((b, k), generator=gen, device=logits.device)
    accept = u * qd < pd                    # u < min(1, p/q), div-free
    n_acc = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)
    resid = torch.clamp(p[:, :k] - q, min=0.0)
    rsum = resid.sum(dim=-1, keepdim=True)
    # a rejection implies the residual has mass; the fallback to the raw
    # target distribution only guards numerics on never-taken branches
    resid = torch.where(rsum > 1e-9, resid / torch.clamp(rsum, min=1e-30),
                        p[:, :k])
    dists = torch.cat([resid, p[:, k:]], dim=1)              # [B,K+1,V]
    corr = torch.gather(dists, 1, n_acc[:, None, None].expand(b, 1, v))[:, 0]
    sampled = _categorical(torch.log(corr + 1e-30), gen).to(torch.int32)
    greedy = torch.argmax(corr, dim=-1).to(torch.int32)
    tok_corr = torch.where(temperature > 0.0, sampled, greedy)
    idx = torch.arange(k + 1, device=logits.device)[None, :]
    cand = torch.cat([drafts.to(torch.int32),
                      torch.zeros((b, 1), dtype=torch.int32,
                                  device=logits.device)], dim=1)
    cand = torch.where(idx == n_acc[:, None], tok_corr[:, None], cand)
    return cand, n_acc.to(torch.int32)


def spec_update(state: Dict[str, torch.Tensor], cand: torch.Tensor,
                n_acc: torch.Tensor, commit: Optional[torch.Tensor] = None
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                           torch.Tensor]:
    """Multi-token ``decode_update``: commit up to ``n_acc + 1`` tokens
    per committing slot, clamped to the remaining budget and cut after
    the first EOS; append them to the drafting history and advance the
    speculative counters.  Returns ``(state', emitted [B,K+1], n_emit
    [B])``: ``emitted`` holds the committed tokens left-aligned, -1
    after them (what the chunk stacks for the drain), and ``n_emit`` is
    how far the cache ``len`` may advance — rejected drafts roll back by
    not being counted.  ``commit`` [B] (default: every active slot): the
    fused chunk passes ``active & ~prefilling``, so a slot drafts nothing
    and counts nothing until its prefill has completed."""
    active = state["active"]
    if commit is None:
        commit = active
    b, k1 = cand.shape
    dev = cand.device
    idx = torch.arange(k1, dtype=torch.int32, device=dev)[None, :]
    rem = torch.clamp(state["max_new"] - state["out_len"], min=0)
    zero = torch.zeros_like(rem)
    n0 = torch.where(commit, torch.minimum(n_acc + 1, rem), zero)
    iseos = (cand == state["eos"][:, None]) & (idx < n0[:, None])
    epos = torch.where(iseos, idx, k1 + 1).amin(dim=1)
    n_emit = torch.minimum(n0, epos + 1)
    emitted = torch.where(idx < n_emit[:, None], cand,
                          torch.full_like(cand, -1))
    out_len = state["out_len"] + n_emit
    hit_eos = epos + 1 <= n0
    done = commit & (hit_eos | (out_len >= state["max_new"]))
    last = torch.gather(cand, 1,
                        torch.clamp(n_emit - 1, min=0).long()[:, None])[:, 0]
    tokens = torch.where(commit & (n_emit > 0), last, state["tokens"])
    # acceptance over USABLE drafts: a budget-clamped last step can emit
    # at most ``rem`` tokens, so drafts past that are no rejections
    usable = torch.where(commit, torch.clamp(rem, max=k1 - 1), zero)
    i32 = torch.int32
    new_state = dict(
        state, tokens=tokens, out_len=out_len, active=active & ~done,
        spec_steps=state["spec_steps"] + commit.sum().to(i32),
        spec_drafted=state["spec_drafted"] + usable.sum().to(i32),
        spec_accepted=state["spec_accepted"] + torch.where(
            commit, torch.minimum(n_acc, n_emit), zero).sum().to(i32),
        spec_emitted=state["spec_emitted"] + n_emit.sum().to(i32))
    if "hist" in state:    # n-gram corpus: append the committed tokens
        hist, hist_len = state["hist"], state["hist_len"]
        cap = hist.shape[1] - 1
        pos = torch.where(idx < n_emit[:, None], hist_len[:, None] + idx,
                          cap)
        pos = torch.clamp(pos, max=cap)     # overflow -> spill column
        rows = torch.arange(b, device=dev)[:, None].expand(b, k1)
        new_state["hist"] = hist.index_put(
            (rows, pos.long()), torch.clamp(emitted, min=0))
        new_state["hist_len"] = hist_len + n_emit
    return new_state, emitted, n_emit
