"""whisper-medium [arXiv:2212.04356]: encoder-decoder, conv frontend STUB.

24 encoder + 24 decoder layers, d_model=1024, 16 heads (kv=16), d_ff=4096,
vocab=51865.  The conv/mel frontend is stubbed: the encoder takes 1500
precomputed frame embeddings [B, 1500, d] (``batch["frames"]``).
"""

from repro_torch.configs.base import (ModelConfig, uniform_blocks,
                                      validate)

NUM_FRAMES = 1500  # 30 s of audio after the conv frontend


def config() -> ModelConfig:
    n = 24
    return validate(ModelConfig(
        name="whisper-medium",
        family="audio",
        num_layers=n,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=51865,
        blocks=uniform_blocks(n),
        enc_layers=n,
        enc_blocks=uniform_blocks(n),
        cross_attention=True,
        frontend="frames",
        frontend_len=NUM_FRAMES,
        rope_theta=10_000.0,
    ))
