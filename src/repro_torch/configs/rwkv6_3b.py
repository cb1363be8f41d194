"""rwkv6-3b [ssm] — "Finch": attention-free, data-dependent decay.

Source: RWKV-6 [arXiv:2404.05892]; 32 layers, d_model 2560 (40 heads of
64), d_ff 8960, vocab 65536.  O(1)-state decode.
"""
from repro_torch.common.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", family="ssm",
        num_layers=32, d_model=2560, d_ff=8960, vocab_size=65536,
        source="arXiv:2404.05892",
    )


def smoke() -> ModelConfig:
    return config().replace(name="rwkv6-smoke", num_layers=2, d_model=128,
                            d_ff=256, vocab_size=512)
