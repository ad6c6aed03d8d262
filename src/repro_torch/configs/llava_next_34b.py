"""llava-next-34b [vlm] — LM backbone only; anyres patch embeddings are a
stub input from input_specs(). [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, d_head=128, rope_theta=5_000_000.0,
    frontend="patches", frontend_len=2880,  # anyres: 5 tiles x 576 patches
)
