"""Batched serving on the sync-free fast path: 8 ragged requests through
4 cache slots of a reduced rwkv6 (O(1)-state decode), plus a
prefill/decode consistency check and a temperature/top-k sampling demo
(counterpart of ``examples/serve_batched.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]

On the card by default (the prefills through the ``rwkv6_wkv`` kernel);
``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models import forward_prefill, model_defs
from repro_torch.models.module import init_params
from repro_torch.serve.engine import Engine, Request


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = reduced(get_config("rwkv6-7b"), layers=2, d_model=64)
    params = init_params(model_defs(cfg), 0, device=dev)
    eng = Engine(cfg, params, slots=4, max_len=64, device=dev)
    eng.warmup()   # the prefill buckets and the decode chunk, once each
    t0 = time.perf_counter()
    for i in range(8):
        # ragged prompt lengths exercise the power-of-two prefill buckets
        eng.submit(Request(rid=i, prompt=[(7 * i + j) % cfg.vocab_size
                                          for j in range(3 + i)],
                           max_new_tokens=10))
    done = eng.run()
    dt = time.perf_counter() - t0
    for r in sorted(done, key=lambda r: r.rid):
        print(f"req {r.rid}: {r.out_tokens}")
    toks = sum(len(r.out_tokens) for r in done)
    print(f"{len(done)} requests / {toks} tokens in {dt:.2f}s "
          f"({eng.steps} batched decode steps, {eng.host_syncs} host "
          f"syncs, {eng.prefill_compiles} prefill compiles for "
          f"{len(set(len(r.prompt) for r in done))} prompt lengths)")
    if not (len(done) == 8 and all(len(r.out_tokens) == 10 for r in done)):
        raise RuntimeError("not every request completed its 10 tokens")

    # consistency: greedy continuation from the engine matches teacher-forced
    # logits from a fresh unpadded prefill of prompt+generated tokens
    r0 = min(done, key=lambda r: r.rid)
    full = r0.prompt + r0.out_tokens[:-1]
    with torch.no_grad():
        logits, _ = forward_prefill(params, cfg, {"tokens": torch.tensor(
            [full], dtype=torch.int32, device=dev)})
    nxt = int(torch.argmax(logits[0]))
    if nxt != r0.out_tokens[-1]:
        raise RuntimeError(f"prefill/decode mismatch: {nxt} vs "
                           f"{r0.out_tokens[-1]}")
    print("prefill/decode consistency check passed")

    # non-greedy: on-device temperature + top-k sampling, seeded generator
    eng2 = Engine(cfg, params, slots=2, max_len=64, greedy=False,
                  temperature=1.0, top_k=8, seed=7, device=dev)
    for i in range(4):
        eng2.submit(Request(rid=i, prompt=[5, 6, 7], max_new_tokens=8))
    sampled = eng2.run()
    if not (len(sampled) == 4 and all(len(r.out_tokens) == 8
                                      for r in sampled)):
        raise RuntimeError("not every sampled request completed")
    outs = {tuple(r.out_tokens) for r in sampled}
    print(f"sampled {len(outs)} distinct continuations from 4 identical "
          f"prompts (temperature=1.0, top_k=8)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
