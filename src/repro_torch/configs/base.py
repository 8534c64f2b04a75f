"""Model/config system.

Counterpart of `repro.configs.base`, with torch dtypes.  A model is
described by a sequence of *layer groups*; each group is a tuple of
``LayerSpec`` repeated ``repeat`` times.  Parameters and caches of a group
are stacked on a leading repeat axis, and the forward pass loops over it.

Every assigned architecture maps onto this one substrate:

  mixer: "attn"        full causal self attention (GQA, optional qk-norm)
         "attn_local"  sliding-window causal attention
         "ssd"         Mamba2 state-space-duality block
         "none"        no mixer (pure-MLP layer; unused by assigned archs)
  mlp:   "dense" | "moe" | "none"
  shared_attn: bool    Zamba2-style weight-tied global attention applied after
                       the mixer (params shared across all applications); with
                       ``shared_blocks`` > 0 the published Zamba2 block instead,
                       run before the mixer and feeding its input.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"           # "attn" | "attn_local" | "ssd" | "none"
    mlp: str = "dense"            # "dense" | "moe" | "none"
    shared_attn: bool = False     # apply the weight-tied shared attention block


@dataclass(frozen=True)
class GroupSpec:
    layers: Tuple[LayerSpec, ...]
    repeat: int

    @property
    def num_layers(self) -> int:
        return len(self.layers) * self.repeat


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    groups: Tuple[GroupSpec, ...]

    # --- attention options -------------------------------------------------
    window_size: int = 1024       # for "attn_local"
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    mrope: bool = False           # multimodal 3D RoPE (Qwen2-VL)
    mrope_sections: Tuple[int, ...] = (16, 24, 24)  # t,h,w splits of head_dim/2
    attn_logit_softcap: float = 0.0
    attn_scale: Optional[float] = None  # the scores' scale; None: 1/sqrt(D)

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    shared_expert: bool = False   # llama4-style shared expert alongside routed
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # --- SSD / Mamba2 ------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    ssm_conv_width: int = 4
    ssd_chunk: int = 256
    ssm_conv_bias: bool = False   # a bias on each causal conv, before its SiLU

    # --- shared attention (Zamba2) ------------------------------------------
    shared_attn_heads: int = 0    # 0 => num_heads
    shared_attn_kv_heads: int = 0
    # The published Zamba2 block (Zyphra/Zamba2-7B), where > 0: a layer
    # with ``shared_attn`` first runs block (its application number mod
    # shared_blocks) on concat(x, x0), x0 the embedding's output: RMS norm,
    # attention (2 d_model in, d_model out), RMS norm, a GELU-gated MLP of
    # d_ff whose gate and up projections add a rank-``shared_adapter_rank``
    # adapter of the application's own; then the layer's own d_model x
    # d_model linear, added to the mixer's input and not to the residual.
    shared_blocks: int = 0
    shared_adapter_rank: int = 0

    # --- encoder/decoder ----------------------------------------------------
    is_encdec: bool = False
    encoder_groups: Tuple[GroupSpec, ...] = ()
    # ratio tgt_len = seq_len // tgt_ratio for encdec shapes
    encdec_tgt_ratio: int = 4

    # --- input modality ----------------------------------------------------
    # "tokens": int32 token ids.  "embeds": the modality frontend is a stub and
    # inputs arrive as precomputed (B, S, d_model) embeddings (VLM/audio).
    input_kind: str = "tokens"

    # --- numerics / substrate ----------------------------------------------
    dtype: str = "bfloat16"       # activation/compute dtype
    param_dtype: str = "float32"  # master params (training)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    use_pallas: bool = False      # hand-written kernels (CUDA); else torch paths
    remat: str = "full"           # "none" | "full" | "dots" activation ckpt
    attn_impl: str = "auto"       # "auto" | "flash" | "brick" | "full"
    loss_chunk: int = 1024        # seq-chunked cross-entropy (0 = unchunked)
    micro_steps: int = 1          # gradient-accumulation microbatches
    # --- beyond-paper perf knobs (see EXPERIMENTS.md §Perf) ---------------
    tp_sp: bool = False           # explicit reduce-scatter row-parallel projs
    pad_attn_heads: bool = False  # pad GQA q-head groups to TP multiple
    moe_a2a_int8: bool = False    # quantize MoE all-to-all dispatch buffers
    attn_chunk_q: int = 1024      # blocked-attention query chunk (torch path)
    attn_chunk_kv: int = 1024     # blocked-attention kv chunk (torch path)
    # Sub-quadratic capable: safe to lower 500k-token decode.
    subquadratic: bool = False

    # ------------------------------------------------------------------ #
    @property
    def num_layers(self) -> int:
        n = sum(g.num_layers for g in self.groups)
        if self.is_encdec:
            n += sum(g.num_layers for g in self.encoder_groups)
        return n

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def act_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def master_dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Parameter count (token-embedding excluded flag for 6ND accounting).
    def param_count(self, include_embed: bool = True) -> int:
        from repro_torch.models.registry import count_params  # lazy, avoids cycle
        return count_params(self, include_embed=include_embed)

    def active_param_count(self) -> int:
        from repro_torch.models.registry import count_params
        return count_params(self, include_embed=True, active_only=True)


# --------------------------------------------------------------------------- #
# Input shapes assigned to every LM architecture.
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def dense_groups(n_layers: int, mixer: str = "attn", mlp: str = "dense"
                 ) -> Tuple[GroupSpec, ...]:
    return (GroupSpec((LayerSpec(mixer=mixer, mlp=mlp),), n_layers),)


# --------------------------------------------------------------------------- #
# Registry
# --------------------------------------------------------------------------- #
_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # import the modules so they self-register
    from repro_torch import configs as _c  # noqa: F401
    import importlib
    if name not in _REGISTRY:
        try:
            mod = name.replace("-", "_").replace(".", "_")
            importlib.import_module(f"repro_torch.configs.{mod}")
        except ImportError:
            pass
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list:
    import importlib
    for m in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    return sorted(_REGISTRY)


ARCH_MODULES = [
    "internlm2_20b",
    "gemma3_12b",
    "granite_8b",
    "qwen3_14b",
    "qwen2_vl_2b",
    "llama4_scout_17b_a16e",
    "qwen3_moe_30b_a3b",
    "mamba2_2_7b",
    "zamba2_7b",
    "seamless_m4t_medium",
    "zamba2_7b_instruct",       # the port's own: not in ARCH_IDS below
]

# the assigned architectures, as the JAX package lists them
ARCH_IDS = [
    "internlm2-20b",
    "gemma3-12b",
    "granite-8b",
    "qwen3-14b",
    "qwen2-vl-2b",
    "llama4-scout-17b-a16e",
    "qwen3-moe-30b-a3b",
    "mamba2-2.7b",
    "zamba2-7b",
    "seamless-m4t-medium",
]


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    def shrink_groups(groups):
        out = []
        for g in groups:
            out.append(GroupSpec(g.layers, repeat=min(g.repeat, 2)))
        return tuple(out)

    kw = dict(
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        groups=shrink_groups(cfg.groups),
        window_size=min(cfg.window_size, 32),
        attn_chunk_q=16,
        attn_chunk_kv=32,
        ssd_chunk=16,
        remat="none",
    )
    if cfg.num_experts:
        kw.update(num_experts=min(cfg.num_experts, 4),
                  experts_per_token=min(cfg.experts_per_token, 2),
                  moe_d_ff=64)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16)
    if cfg.mrope:
        kw.update(mrope_sections=(2, 3, 3))   # sums to head_dim/2 = 8
    if cfg.is_encdec:
        kw.update(encoder_groups=shrink_groups(cfg.encoder_groups))
    if cfg.shared_attn_heads:
        kw.update(shared_attn_heads=4, shared_attn_kv_heads=2)
    if cfg.shared_adapter_rank:
        kw.update(shared_adapter_rank=8)
    return cfg.replace(**kw)
