"""qwen2-1.5b — dense GQA decoder with QKV bias. [arXiv:2407.10671; hf]

28L, d_model 1536, 12 heads (GQA kv=2, head_dim 128), d_ff 8960,
vocab 151936.  Small-model/high comm-to-compute ratio: the MG-WFBP sweet
spot (paper regime).
"""

from repro_torch.configs.base import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    act="swiglu",
    rope_theta=1e6,
)

PARALLEL = ParallelConfig(zero=1, tp_enabled=False)
MICROBATCH = {"train_4k": 8}
SKIP_SHAPES = {"long_500k": "pure full-attention arch: 524k decode is not "
                            "sub-quadratic-servable (DESIGN.md §5)"}
