"""Deterministic synthetic token pipeline and a device prefetcher
(counterpart of ``repro/data/pipeline.py``).

``SyntheticLM.batch_at(step)`` is a pure function of (seed, step): a
counter-based hash (splitmix64) gives O(1) random access by step, so a
restarted run replays the exact stream and a checkpoint needs nothing
of the pipeline beyond the step.  It is numpy only and gives the
reference's arrays bit for bit.

``DevicePrefetcher`` builds the next batches on a background thread,
pins them and copies them to the device with ``non_blocking=True``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@dataclasses.dataclass
class SyntheticLM:
    """Markov-ish synthetic LM data: the next token is ``(31 x + 17) %
    vocab`` of the current one, or (one time in four) a fresh random
    token, so a model can learn it and smoke training shows a falling
    loss.  ``batch_at(step)`` -> ``tokens``, ``labels`` [B,S] int32 and,
    for a frontend arch, ``frames`` (audio) or ``frontend`` [B,F,d]
    fp32 stub embeddings."""

    cfg: ModelConfig
    batch: int
    seq_len: int
    seed: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        b, s, v = self.batch, self.seq_len, self.cfg.vocab_size
        idx = (np.uint64(self.seed) * np.uint64(0x1000003)
               + np.uint64(step) * np.uint64(b * (s + 1) + 7)
               + np.arange(b * (s + 1), dtype=np.uint64))
        noise = _splitmix64(idx).reshape(b, s + 1)
        stream = np.empty((b, s + 1), np.int64)
        stream[:, 0] = noise[:, 0] % v
        for t in range(1, s + 1):
            det = (stream[:, t - 1] * 31 + 17) % v
            rnd = noise[:, t] % v
            take_rnd = (noise[:, t] >> np.uint64(32)) % np.uint64(4) == 0
            stream[:, t] = np.where(take_rnd, rnd, det)
        out = {"tokens": stream[:, :-1].astype(np.int32),
               "labels": stream[:, 1:].astype(np.int32)}
        if self.cfg.frontend:
            fl = self.cfg.frontend_len
            f = _splitmix64(np.uint64(self.seed * 7 + 3)
                            + np.uint64(step) * np.uint64(b * fl)
                            + np.arange(b * fl, dtype=np.uint64))
            frames = (f.astype(np.float64) / 2**64 - 0.5).astype(np.float32)
            frames = np.broadcast_to(frames.reshape(b, fl, 1),
                                     (b, fl, self.cfg.d_model)) * 0.2
            key = "frames" if self.cfg.family == "audio" else "frontend"
            out[key] = np.ascontiguousarray(frames, np.float32)
        return out


def to_device(batch: Dict[str, np.ndarray],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device``: pinned and copied with
    ``non_blocking=True`` on the card, plain tensors on the CPU."""
    out = {}
    for key, val in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(val))
        if device.type != "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        out[key] = t
    return out


class DevicePrefetcher:
    """Background host->device prefetch: a worker thread builds batches
    from ``start_step`` on and queues ``(step, device batch)``, at most
    ``depth`` ahead.  An error in the worker is raised by the next
    ``next()``; ``close()`` stops the worker and drops what is queued."""

    def __init__(self, source: SyntheticLM, device: DeviceLike = None,
                 depth: int = 2, start_step: int = 0):
        self.source = source
        self.device = resolve_device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)
        pending = None
        while not self._stop.is_set():
            try:
                if pending is None:
                    host = self.source.batch_at(self._step)
                    if stream is None:
                        pending = to_device(host, self.device)
                    else:
                        with torch.cuda.stream(stream):
                            pending = to_device(host, self.device)
                        # the consumer's stream waits for the copies
                        done = torch.cuda.Event()
                        done.record(stream)
                        pending = (pending, done)
                    pending = (self._step, pending)
                self._q.put(pending, timeout=0.1)
                pending = None
                self._step += 1
            except queue.Full:
                continue
            except Exception as e:     # surface errors to the consumer
                self._q.put(e)
                return

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        step, batch = item
        if isinstance(batch, tuple):
            batch, done = batch
            torch.cuda.current_stream(self.device).wait_event(done)
            for t in batch.values():
                t.record_stream(torch.cuda.current_stream(self.device))
        return step, batch

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


__all__ = ["SyntheticLM", "DevicePrefetcher", "to_device"]
