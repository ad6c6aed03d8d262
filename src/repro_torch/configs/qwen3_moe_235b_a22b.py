"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, qk_norm, GQA kv=4.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab=151936, d_head=128, qk_norm=True, rope_theta=1_000_000.0,
    moe=MoESpec(n_experts=128, top_k=8, d_ff_expert=1536),
)
