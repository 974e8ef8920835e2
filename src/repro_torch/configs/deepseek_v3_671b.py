"""DeepSeek-V3-671B [arXiv:2412.19437]: MLA + 1 shared / 256 routed top-8
MoE with a depth-1 MTP head.

61 layers (the first 3 dense, d_ff=18432), d_model=7168, 128 heads,
routed-expert d_ff=2048, vocab=129280.  MLA: q_lora=1536, kv_lora=512,
qk_nope=128, qk_rope=64, v_head=128: the latent KV cache holds 512+64
values per token.  bf16 parameters.  A copy of the JAX package's
``configs/deepseek_v3_671b.py`` less its XLA dispatch knob.
"""
from repro_torch.configs.base import ArchConfig, MonitorConfig

FULL = ArchConfig(
    name="deepseek-v3-671b", family="moe", citation="arXiv:2412.19437",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=18432,
    vocab_size=129280,
    n_experts=256, top_k=8, n_shared_experts=1, moe_d_ff=2048,
    first_dense_layers=3, capacity_factor=1.25,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128, mtp_depth=1,
    param_dtype="bfloat16", long_context_window=8192,
    monitor=MonitorConfig(n_layers=2, d_model=256, n_heads=4, d_ff=1024,
                          n_features=64),
)

SMOKE = FULL.replace(
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
    vocab_size=512, n_experts=4, top_k=2, n_shared_experts=1, moe_d_ff=128,
    first_dense_layers=1, use_mla=True, q_lora_rank=64, kv_lora_rank=64,
    qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32, mtp_depth=1,
    remat=False, dtype="float32", param_dtype="float32",
    monitor=MonitorConfig(n_layers=1, d_model=64, n_heads=2, d_ff=128,
                          n_features=16),
)
