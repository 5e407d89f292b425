"""internlm2-1.8b [arXiv:2403.17297].

24 layers, d_model=2048, 16 heads (GQA kv=8), d_ff=8192, vocab=92544.
"""

from repro_torch.configs.base import ModelConfig, uniform_blocks, validate


def config() -> ModelConfig:
    n = 24
    return validate(ModelConfig(
        name="internlm2-1.8b",
        family="dense",
        num_layers=n,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=92544,
        blocks=uniform_blocks(n),
        rope_theta=1_000_000.0,
    ))
