"""qwen2-7b [dense]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — GQA, QKV bias  [arXiv:2407.10671; hf]"""
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import register


@register("qwen2-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b", family="dense",
        num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
        head_dim=128, d_ff=18_944, vocab_size=152_064,
        qkv_bias=True, rope_theta=1_000_000.0, max_seq=131_072)


SMOKE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=128, vocab_size=512, max_seq=256)
