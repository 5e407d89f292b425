"""grok-1-314b: MoE, 8 experts top-2 [hf:xai-org/grok-1].

64 layers, d_model=6144, 48 heads (GQA kv=8), d_ff=32768 per expert,
vocab=131072.  Grok clips attention logits (softcap 30).
"""

from repro_torch.configs.base import (FFN_MOE, ModelConfig, MoEConfig,
                                      uniform_blocks, validate)


def config() -> ModelConfig:
    n = 64
    return validate(ModelConfig(
        name="grok-1-314b",
        family="moe",
        num_layers=n,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=32768,
        vocab_size=131072,
        blocks=uniform_blocks(n, ffn=FFN_MOE),
        moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25),
        attn_softcap=30.0,
        embed_scale=True,
        rope_theta=10_000.0,
    ))
