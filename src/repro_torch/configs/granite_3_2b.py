"""granite-3-2b [dense] — GQA kv=8 (port of ``repro.configs.granite_3_2b``).

40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155
[hf:ibm-granite/granite-3.0-2b-base].
"""
from repro_torch.configs.base import ModelConfig, register


@register("granite-3-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b", family="dense",
        num_layers=40, d_model=2048, num_heads=32, num_kv_heads=8,
        d_ff=8192, vocab_size=49155, mlp="swiglu",
    )
