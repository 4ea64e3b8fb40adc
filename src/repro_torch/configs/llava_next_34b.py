"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling; the vision tower is a STUB (input_specs provides
precomputed patch embeddings prepended to the text sequence)
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import register


@register("llava-next-34b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b", family="dense",
        num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
        head_dim=128, d_ff=20_480, vocab_size=64_000,
        frontend="patch_stub", num_patches=576,
        rope_theta=5_000_000.0, max_seq=131_072)


SMOKE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=128, vocab_size=512, num_patches=8,
             max_seq=256)
