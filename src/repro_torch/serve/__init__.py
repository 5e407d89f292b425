"""Serving runtime of the port: paged cache, sampling, scheduler and the
fused chunked-prefill engine (counterpart of ``repro/serve``)."""

from repro_torch.serve import cache, engine, sampling, scheduler, spec
from repro_torch.serve.cache import CacheSpec
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import PagePool, PagePoolExhausted, Request

__all__ = ["cache", "engine", "sampling", "scheduler", "spec", "CacheSpec",
           "Engine", "Request", "PagePool", "PagePoolExhausted"]
