"""whisper-large-v3 [audio]: 32L d_model=1280 20H (kv=20) d_ff=5120
vocab=51866 — enc-dec, conv frontend STUB (input_specs provides precomputed
frame embeddings)  [arXiv:2212.04356; unverified]"""
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import register


@register("whisper-large-v3")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="encdec",
        num_layers=32, encoder_layers=32, d_model=1280,
        num_heads=20, num_kv_heads=20, head_dim=64, d_ff=5120,
        vocab_size=51_866, encoder_seq=1500,
        norm_type="layernorm", mlp_type="gelu", pos_embed="learned",
        qkv_bias=True, frontend="audio_stub", max_seq=32_768)


SMOKE = dict(num_layers=2, encoder_layers=2, d_model=64, num_heads=4,
             num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
             encoder_seq=24, max_seq=256)
