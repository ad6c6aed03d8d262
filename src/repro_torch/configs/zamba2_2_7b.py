"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attn block (LoRA-adapted).
[arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ArchConfig, SSMSpec

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000, d_head=80,
    ssm=SSMSpec(d_state=64, head_dim=64, expand=2, chunk=256),
    hybrid_attn_every=6, hybrid_lora_rank=128,
)
