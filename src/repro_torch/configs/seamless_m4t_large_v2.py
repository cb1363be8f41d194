"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal.

Source: SeamlessM4T [arXiv:2308.11596]; 24 encoder + 24 decoder layers,
d_model 1024, 16 heads (kv=16, MHA, head_dim 64), d_ff 8192,
vocab 256206.  Audio frontend STUBBED per the brief: input_specs
supplies 4096 precomputed frame embeddings.  Decode shapes run the
DECODER against the cached encoder memory; long_500k uses windowed
decoder self-attention (window 32768) + full cross-attention
(DESIGN.md Sec. 5).
"""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="audio",
        num_layers=24, encoder_layers=24,
        d_model=1024, d_ff=8192, vocab_size=256206,
        num_heads=16, num_kv_heads=16, head_dim=64,
        num_audio_frames=4096,
        long_context_window=32768,
        source="arXiv:2308.11596",
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="seamless-smoke", num_layers=2, encoder_layers=2,
        d_model=128, d_ff=256, vocab_size=512, num_heads=4,
        num_kv_heads=4, head_dim=32, num_audio_frames=16,
        long_context_window=16)
