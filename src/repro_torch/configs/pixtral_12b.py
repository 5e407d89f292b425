"""pixtral-12b: pixtral-ViT frontend + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409].

The backbone only: 40 layers, d_model=5120, 32 heads (GQA kv=8,
head_dim=128), d_ff=14336, vocab=131072.  The ViT is a stub: precomputed
patch embeddings [B, 1024, d] (``batch["frontend"]``) take the place of the
first 1024 token embeddings.
"""

from repro_torch.configs.base import (ModelConfig, uniform_blocks,
                                      validate)


def config() -> ModelConfig:
    n = 40
    return validate(ModelConfig(
        name="pixtral-12b",
        family="vlm",
        num_layers=n,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        blocks=uniform_blocks(n),
        frontend="patches",
        frontend_len=1024,
        rope_theta=1_000_000.0,
    ))
