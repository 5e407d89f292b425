"""rwkv6-7b (Finch): attention-free RNN with data-dependent decay
[arXiv:2404.05892].

32 layers, d_model=4096, d_ff=14336, vocab=65536.  Heads are d_model/64
wkv heads; the time-mix plays the mixer role and the channel-mix the FFN
role.  O(1) recurrent state => long_500k applies.
"""

from repro_torch.configs.base import (FFN_RWKV, RWKV6, BlockSpec,
                                      ModelConfig, RWKVConfig, validate)


def config() -> ModelConfig:
    n = 32
    d = 4096
    head_dim = 64
    return validate(ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        num_layers=n,
        d_model=d,
        num_heads=d // head_dim,
        num_kv_heads=d // head_dim,
        d_ff=14336,
        vocab_size=65536,
        blocks=tuple(BlockSpec(mixer=RWKV6, ffn=FFN_RWKV) for _ in range(n)),
        rwkv=RWKVConfig(head_dim=head_dim, decay_lora=64, mix_lora=32,
                        chunk=256),
    ))
