"""Configuration schema: model architecture, input shapes, parallelism.

Port of ``repro.configs.base``: the same dataclasses and fields, so a run
configured for the reference configures the port the same way.  Fields the
port does not act on yet (TP, EP, ZeRO-1/3, hierarchical collectives,
MoE/Mamba/xLSTM) keep their reference meaning and are rejected by the
step builder where they would change the result.

Every assigned architecture is a :class:`ModelConfig` in its own module
(``repro/configs/<id>.py``); the four assigned input shapes are global
(:data:`SHAPES`).  Parallelism / communication-scheduling options live in
:class:`ParallelConfig` — ``comm_strategy`` selects the paper's MG-WFBP plan
or one of its baselines (WFBP, SyncEASGD-single, fixed-size buckets).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # FFN hidden size per routed expert
    num_shared_experts: int = 0   # deepseek-moe: always-on shared experts
    shared_d_expert: int = 0      # hidden size of each shared expert
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 -> ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act: str = "swiglu"           # swiglu | gelu
    rope_theta: float = 10000.0
    # --- sliding-window / local-global attention (gemma3) ---
    sliding_window: int = 0       # 0 = full attention
    global_interval: int = 0      # every Nth layer is global (rest local)
    # --- MoE ---
    moe: Optional[MoEConfig] = None
    moe_interval: int = 1         # MoE FFN every k-th layer (jamba: 2)
    moe_skip_first: int = 0       # deepseek-moe: first layer is dense FFN
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    # --- hybrid (jamba): attention every k-th layer, Mamba elsewhere ---
    attn_interval: int = 0        # 0 = attention everywhere
    mamba: Optional[MambaConfig] = None
    # --- xLSTM ---
    xlstm_slstm_interval: int = 0  # every k-th block is sLSTM (rest mLSTM)
    # --- encoder-decoder (whisper) ---
    enc_dec: bool = False
    enc_layers: int = 0
    enc_seq_len: int = 1500       # encoder positions (whisper frames / 2)
    # --- modality frontend stub ---
    frontend: str = ""            # "" | "vision" | "audio"
    frontend_prefix_len: int = 0  # patch/frame embeddings prepended to text
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def block_kind(self, layer_idx: int) -> dict:
        """Describe the block at ``layer_idx`` (mixer type, ffn type,
        attention window).  This drives both model construction and the
        repeat-group decomposition used for scanned stacks."""
        if self.attn_interval > 0 and self.mamba is not None:
            mixer = "attn" if layer_idx % self.attn_interval == (
                self.attn_interval // 2) else "mamba"
        elif self.xlstm_slstm_interval > 0:
            mixer = ("slstm" if layer_idx % self.xlstm_slstm_interval ==
                     self.xlstm_slstm_interval - 1 else "mlstm")
        elif self.family == "ssm":
            mixer = "mlstm"
        else:
            mixer = "attn"
        window = 0
        if self.sliding_window and self.global_interval:
            is_global = layer_idx % self.global_interval == self.global_interval - 1
            window = 0 if is_global else self.sliding_window
        elif self.sliding_window:
            window = self.sliding_window
        if self.moe is not None and layer_idx >= self.moe_skip_first and (
                layer_idx % self.moe_interval == self.moe_interval - 1):
            ffn = "moe"
        elif self.d_ff > 0:
            ffn = "dense"
        else:
            ffn = "none"   # xlstm blocks carry their own projections
        return {"mixer": mixer, "ffn": ffn, "window": window}

    def repeat_period(self) -> int:
        """Length of the repeating block pattern (scan group size)."""
        kinds = [tuple(sorted(self.block_kind(i).items()))
                 for i in range(self.moe_skip_first, self.num_layers)]
        n = len(kinds)
        for period in range(1, n + 1):
            if n % period == 0 and all(
                    kinds[i] == kinds[i % period] for i in range(n)):
                return period
        return n


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    dp_axes: tuple[str, ...] = ("data",)   # manual (shard_map) DP axes
    tp_axis: str = "model"                 # GSPMD auto axis
    tp_enabled: bool = True                # False: model axis joins DP
                                           # (small models: TP-16 of 12-head
                                           # attention only buys gathers)
    ep_axis: str = ""                      # "" = experts TP-sharded only
    zero: int = 0                          # 0 replicated, 1 ZeRO-1, 3 FSDP
    comm_strategy: str = "mgwfbp"          # wfbp|single|mgwfbp|dp_optimal|fixed:N
    hierarchical: bool = True              # pod-aware two-level collectives
    wire_dtype: str = ""                   # "" native | "bfloat16" compress
    remat: str = "block"                   # none | block | alternating
                                           # (alternating: remat every 2nd
                                           # group — halves recompute FLOPs
                                           # for ~1 group of live internals)
    scan_layers: bool = True
    attn_chunk: int = 1024                 # KV chunk for online-softmax attn
    seq_shard_decode: bool = False         # shard KV seq over data (batch=1)
    # --- MoE perf knobs (§Perf iterations) ---
    moe_token_shard: bool = False          # shard expert compute over the
                                           # capacity dim instead of d_ff:
                                           # removes the TP all-reduce of the
                                           # 7.5x-capacity down-proj output
                                           # at the cost of replicating
                                           # expert weights across TP
    moe_combine_dtype: str = ""            # "" = fp32 combine (baseline);
                                           # "bfloat16" halves a2a cotangent
                                           # traffic
    moe_capacity_factor: float = 0.0       # 0 = config default
    # --- merged-gradient execution ---
    pack_kernel: bool = False              # route bucket pack/unpack through
                                           # the kernels/bucket_pack CUDA
                                           # kernels (TILE-aligned slots,
                                           # paper §5.3 contiguous buffers);
                                           # False = plain concatenated
                                           # layout


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    parallel: ParallelConfig = ParallelConfig()
    seed: int = 0
    learning_rate: float = 3e-4
    warmup_steps: int = 100                # LR schedule warmup length
    total_steps: int = 10000               # LR schedule horizon
    weight_decay: float = 0.01
    optimizer: str = "adamw"               # adamw | sgdm
    optimizer_state_dtype: str = "float32" # bf16 moments for 480B-class
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    adam_eps: float = 1e-8
    sgd_momentum: float = 0.9
    grad_clip: float = 1.0
    microbatch: int = 0                    # 0 = no gradient accumulation


def reduced(cfg: ModelConfig, *, num_layers: int = 2, d_model: int = 64,
            num_heads: int = 4, num_kv_heads: int = 0, d_ff: int = 128,
            vocab_size: int = 512, num_experts: int = 0) -> ModelConfig:
    """Small same-family config for CPU smoke tests.

    Keeps every structural feature (GQA ratio, MoE, hybrid pattern, enc-dec,
    sliding window) while shrinking widths/depths.
    """
    kv = num_kv_heads or max(1, num_heads * cfg.num_kv_heads // cfg.num_heads)
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe,
            num_experts=num_experts or min(cfg.moe.num_experts, 8),
            top_k=min(cfg.moe.top_k, num_experts or 8),
            d_expert=max(32, d_ff // 4),
            shared_d_expert=(max(32, d_ff // 4)
                             if cfg.moe.num_shared_experts else 0),
        )
    updates = dict(
        num_layers=num_layers, d_model=d_model, num_heads=num_heads,
        num_kv_heads=kv, d_ff=d_ff if cfg.d_ff > 0 else 0,
        vocab_size=vocab_size, head_dim=0, moe=moe,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
    )
    if cfg.enc_dec:
        updates["enc_layers"] = max(1, num_layers // 2)
        updates["enc_seq_len"] = 32
    if cfg.attn_interval:
        updates["attn_interval"] = min(cfg.attn_interval, num_layers)
    if cfg.global_interval:
        updates["global_interval"] = min(cfg.global_interval, num_layers)
    if cfg.xlstm_slstm_interval:
        updates["xlstm_slstm_interval"] = min(cfg.xlstm_slstm_interval,
                                              num_layers)
    if cfg.mamba is not None:
        updates["mamba"] = dataclasses.replace(cfg.mamba, d_state=8)
    if cfg.frontend:
        updates["frontend_prefix_len"] = 8
    return dataclasses.replace(cfg, **updates)
