"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407].

88 layers, d_model=12288, 96 heads (GQA kv=8, head_dim=128), d_ff=28672,
vocab=32768.  Dense, full attention.
"""

from repro_torch.configs.base import (ModelConfig, uniform_blocks,
                                      validate)


def config() -> ModelConfig:
    n = 88
    return validate(ModelConfig(
        name="mistral-large-123b",
        family="dense",
        num_layers=n,
        d_model=12288,
        num_heads=96,
        num_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=32768,
        blocks=uniform_blocks(n),
        rope_theta=1_000_000.0,
    ))
