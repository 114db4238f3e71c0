"""Architecture configs (port of ``repro.configs.base``).

:class:`ModelConfig` is the JAX package's dataclass, field for field, so
that a config means the same model in both packages; ``reduced()`` is the
CPU-test variant of the same family.  The registry holds only the
architectures the port runs; :func:`get_config` of another one raises
``KeyError`` naming the ROADMAP item that brings it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int            # 0 for attention-free families
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0         # 0 -> d_model // num_heads
    mlp: str = "swiglu"       # swiglu | squared_relu | gelu
    norm_eps: float = 1e-5
    rope_theta: float = 1e4
    # --- MoE ---
    num_experts: int = 0
    experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    first_dense_layers: int = 0   # moonlight: leading dense layer(s)
    # --- attention extras ---
    sliding_window: int = 0       # 0 = full attention
    # --- SSM / hybrid ---
    ssm_state: int = 0            # Mamba2 N (zamba2) — 0 for non-SSM
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    attn_every: int = 0           # zamba2: shared attn block every k layers
    rwkv_head_dim: int = 64
    # --- modality frontend stub ---
    frontend: str = "none"        # none | vision | audio
    num_patches: int = 256        # vision stub: patch embeddings per image
    # --- technique ---
    routed_embedding: bool = True  # Dalorex vocab-routed embedding lookup
    # ring (context-parallel) attention for train/prefill on a mesh —
    # §Perf train iteration B; falls back to gather-style when the model
    # axis does not divide the sequence
    context_parallel: bool = True
    # --- numerics ---
    dtype: str = "bfloat16"
    # --- lowering ---
    # scan_unroll=True unrolls the layer stack + loss chunks: used by the
    # roofline PROBE lowering so HLO flop/byte/collective counters (which see
    # a while body once) become exact; full-config compiles keep scans rolled
    # for O(1) HLO size.
    scan_unroll: bool = False

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k decode? (bounded per-token state)"""
        return (self.family in ("ssm", "hybrid")
                or (self.sliding_window > 0))

    def reduced(self) -> "ModelConfig":
        """Same family, smoke-test size (runs a step on 1 CPU device)."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 4 if self.attn_every == 0
                           else 2 * max(self.attn_every, 1)),
            d_model=128,
            num_heads=min(self.num_heads, 4) if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads,
                             min(self.num_heads, 4)) if self.num_heads else 0,
            head_dim=32 if self.num_heads else 0,
            d_ff=256 if self.num_experts == 0 else 64,
            vocab_size=512,
            num_experts=min(self.num_experts, 8),
            experts_per_tok=min(self.experts_per_tok, 2),
            moe_capacity_factor=4.0,  # drop-free so smoke tests are exact
            sliding_window=min(self.sliding_window, 64) or 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            rwkv_head_dim=32,
            num_patches=8,
            dtype="float32",
        )

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline math)."""
        d, ff, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd = self.hd
        n = V * d  # embedding
        n += V * d  # lm head (untied)
        per_layer = 0
        if self.family == "ssm":  # rwkv6
            per_layer += 4 * d * d + d * d  # r,k,v,o + gate
            per_layer += 2 * d * ff  # channel mix (k, v)... r too
            per_layer += d * ff
        else:
            if self.num_heads:
                q = d * self.num_heads * hd
                kv = 2 * d * self.num_kv_heads * hd
                o = self.num_heads * hd * d
                per_layer += q + kv + o
            if self.num_experts:
                mult = 3 if self.mlp == "swiglu" else 2
                per_layer += self.num_experts * mult * d * ff
                per_layer += d * self.num_experts  # router
            else:
                mult = 3 if self.mlp == "swiglu" else 2
                per_layer += mult * d * ff
            if self.family == "hybrid":
                # mamba2 block: in_proj (x,z,B,C,dt) + out_proj
                din = self.ssm_expand * d
                per_layer += d * (2 * din + 2 * self.ssm_state) + din * d
        n += L * per_layer
        return n

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only selected experts)."""
        if not self.num_experts:
            return self.param_count()
        d, ff, L = self.d_model, self.d_ff, self.num_layers
        mult = 3 if self.mlp == "swiglu" else 2
        total = self.param_count()
        moe_all = L * self.num_experts * mult * d * ff
        moe_active = L * self.experts_per_tok * mult * d * ff
        return total - moe_all + moe_active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}

# architectures of the JAX package that the port does not run yet, and the
# ROADMAP item that brings each
NOT_PORTED = {
    **dict.fromkeys(
        ("granite-34b", "internlm2-20b", "internvl2-76b", "mixtral-8x22b",
         "moonshot-v1-16b-a3b", "musicgen-large", "nemotron-4-15b"),
        "ROADMAP §1, still to port: the rest of the LM substrate"),
}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def _load_archs():
    # import the arch modules lazily so that each self-registers
    from repro_torch.configs import granite_3_2b  # noqa: F401
    from repro_torch.configs import rwkv6_1_6b  # noqa: F401
    from repro_torch.configs import zamba2_2_7b  # noqa: F401


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        _load_archs()
    if name in _REGISTRY:
        return _REGISTRY[name]()
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet: "
                       f"{NOT_PORTED[name]}")
    raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")


def list_archs() -> list[str]:
    _load_archs()
    return sorted(_REGISTRY)
