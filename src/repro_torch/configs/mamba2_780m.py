"""mamba2-780m [ssm]: 48L d_model=1536 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality)  [arXiv:2405.21060; unverified]"""
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import register


@register("mamba2-780m")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm",
        num_layers=48, d_model=1536, vocab_size=50_280,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
        tie_embeddings=True, max_seq=1_048_576)


SMOKE = dict(num_layers=2, d_model=64, vocab_size=512, ssm_state=16,
             ssm_head_dim=16, ssm_chunk=16, max_seq=256)
