"""gemma3-12b [hf:google/gemma-3-1b-pt family, 12B point].

48 layers, d_model=3840, 16 heads (GQA kv=8, head_dim=256), d_ff=15360,
vocab=262144.  5:1 local(1024):global attention pattern, 128k context.
"""

from repro_torch.configs.base import (ModelConfig, alternating_windows,
                                      validate)


def config() -> ModelConfig:
    n = 48
    return validate(ModelConfig(
        name="gemma3-12b",
        family="dense",
        num_layers=n,
        d_model=3840,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=15360,
        vocab_size=262144,
        blocks=alternating_windows(n, [1024, 1024, 1024, 1024, 1024, None]),
        sliding_window=1024,
        tie_embeddings=True,
        embed_scale=True,
        rope_theta=1_000_000.0,
    ))
