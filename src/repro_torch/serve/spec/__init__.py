"""Speculative decoding of the port: the configuration, the capability
gate and the two drafters (counterpart of ``repro/serve/spec``)."""

from repro_torch.serve.spec.config import (SpecConfig, check_spec_capable,
                                           spec_unsupported_reason)
from repro_torch.serve.spec.drafter import (ModelDrafter, NGramDrafter,
                                            ngram_propose)

__all__ = ["SpecConfig", "check_spec_capable", "spec_unsupported_reason",
           "NGramDrafter", "ModelDrafter", "ngram_propose"]
