"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128e top-8  [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import register


@register("qwen3-moe-235b-a22b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
        head_dim=128, d_ff=1536, vocab_size=151_936,
        num_experts=128, experts_per_token=8,
        qk_norm=True, rope_theta=1_000_000.0, max_seq=131_072)


SMOKE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=32, vocab_size=512, num_experts=8,
             experts_per_token=2, moe_capacity_factor=8.0, max_seq=256)
