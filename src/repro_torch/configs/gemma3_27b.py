"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5:1 local:global, 128k  [hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import register


@register("gemma3-27b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b", family="dense",
        num_layers=62, d_model=5376, num_heads=32, num_kv_heads=16,
        head_dim=128, d_ff=21_504, vocab_size=262_144,
        qk_norm=True, tie_embeddings=True,
        local_global_pattern=5, window_size=1024,
        rope_theta=10_000.0, global_rope_theta=1_000_000.0,
        # beyond-paper serving optimization:
        # local layers keep ring-buffer window caches => 2.4x decode bound
        windowed_decode_cache=True,
        max_seq=131_072)


SMOKE = dict(num_layers=6, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=128, vocab_size=512, window_size=16,
             max_seq=256)
