"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attn, 1:2  [arXiv:2402.19427; hf]"""
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import register


@register("recurrentgemma-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
        head_dim=256, d_ff=7680, vocab_size=256_000,
        rnn_width=2560, attn_every=3, window_size=2048,
        tie_embeddings=True, rope_theta=10_000.0, max_seq=1_048_576)


SMOKE = dict(num_layers=6, d_model=64, num_heads=4, num_kv_heads=1,
             head_dim=16, d_ff=128, vocab_size=512, rnn_width=64,
             window_size=16, max_seq=256)
