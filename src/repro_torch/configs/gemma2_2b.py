"""gemma2-2b [arXiv:2408.00118].

26 layers, d_model=2304, 8 heads (GQA kv=4, head_dim=256), d_ff=9216,
vocab=256000.  Local(4096)/global alternating attention, attention and
final-logit softcaps, tied + scaled embeddings.
"""

from repro_torch.configs.base import (ModelConfig, alternating_windows,
                                      validate)


def config() -> ModelConfig:
    n = 26
    return validate(ModelConfig(
        name="gemma2-2b",
        family="dense",
        num_layers=n,
        d_model=2304,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256000,
        blocks=alternating_windows(n, [4096, None]),
        sliding_window=4096,
        attn_softcap=50.0,
        logit_softcap=30.0,
        tie_embeddings=True,
        embed_scale=True,
        rope_theta=10_000.0,
    ))
