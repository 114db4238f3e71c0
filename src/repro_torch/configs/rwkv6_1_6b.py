"""rwkv6-1.6b [ssm] — Finch: attention-free, data-dependent decay (port of
``repro.configs.rwkv6_1_6b``).

24L d_model=2048 d_ff=7168 vocab=65536, head 64 [arXiv:2404.05892].
"""
from repro_torch.configs.base import ModelConfig, register


@register("rwkv6-1.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="ssm",
        num_layers=24, d_model=2048, num_heads=0, num_kv_heads=0,
        d_ff=7168, vocab_size=65536, mlp="rwkv_channel_mix",
        rwkv_head_dim=64,
    )
