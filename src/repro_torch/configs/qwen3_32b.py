"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936 — qk_norm, GQA  [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import register


@register("qwen3-32b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b", family="dense",
        num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=25600, vocab_size=151_936,
        qk_norm=True, rope_theta=1_000_000.0, max_seq=131_072)


SMOKE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=128, vocab_size=512, max_seq=256)
