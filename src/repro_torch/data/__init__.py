"""Data pipeline of the port: the deterministic synthetic token stream
and its host-to-device prefetcher (counterpart of ``repro/data``)."""

from repro_torch.data.pipeline import DevicePrefetcher, SyntheticLM

__all__ = ["SyntheticLM", "DevicePrefetcher"]
