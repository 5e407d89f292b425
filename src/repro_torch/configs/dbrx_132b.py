"""dbrx-132b: fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base].

40 layers, d_model=6144, 48 heads (GQA kv=8), d_ff=10752 per expert,
vocab=100352.
"""

from repro_torch.configs.base import (FFN_MOE, ModelConfig, MoEConfig,
                                      uniform_blocks, validate)


def config() -> ModelConfig:
    n = 40
    return validate(ModelConfig(
        name="dbrx-132b",
        family="moe",
        num_layers=n,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=10752,
        vocab_size=100352,
        blocks=uniform_blocks(n, ffn=FFN_MOE),
        moe=MoEConfig(num_experts=16, top_k=4, capacity_factor=1.25),
        rope_theta=500_000.0,
    ))
