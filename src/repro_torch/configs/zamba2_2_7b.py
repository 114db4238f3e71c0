"""zamba2-2.7b [hybrid] — a Mamba2 backbone with one shared attention
block (port of ``repro.configs.zamba2_2_7b``).

54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000 ssm_state=64
[arXiv:2411.15242].  One attention block, its weights shared, runs before
every 6 Mamba2 layers, each application with its own KV cache slot.
"""
from repro_torch.configs.base import ModelConfig, register


@register("zamba2-2.7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
        d_ff=10240, vocab_size=32000, mlp="swiglu",
        ssm_state=64, ssm_expand=2, ssm_head_dim=64, attn_every=6,
        sliding_window=4096,  # shared attn blocks use a bounded window @500k
    )
