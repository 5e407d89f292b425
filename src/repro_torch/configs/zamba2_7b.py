"""zamba2-7b: Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

81 layers, d_model=3584, 32 heads (kv=32), d_ff=14336, vocab=32000,
ssm_state=64.  Every 6th layer applies one of 2 *shared* transformer
blocks (attention + MLP with parameters shared across applications).
The shared attention runs with a 4096-token sliding window, as in the
reference's config.
"""

from repro_torch.configs.base import (ModelConfig, SSMConfig, validate,
                                      zamba2_blocks)

SHARED_EVERY = 6
NUM_SHARED_GROUPS = 2
WINDOW = 4096


def config() -> ModelConfig:
    n = 81
    return validate(ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        num_layers=n,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        d_ff=14336,
        vocab_size=32000,
        blocks=zamba2_blocks(n, SHARED_EVERY, NUM_SHARED_GROUPS, WINDOW),
        ssm=SSMConfig(state_dim=64, head_dim=64, conv_width=4, chunk=256,
                      expand=2),
        num_shared_groups=NUM_SHARED_GROUPS,
        sliding_window=WINDOW,
        rope_theta=10_000.0,
    ))
