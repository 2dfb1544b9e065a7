"""recurrentgemma-9b [hybrid] — Griffin/RecurrentGemma [arXiv:2402.19427].

38L (must be divisible by the (rec,rec,attn) pattern => 36 recurrent-pattern
layers + 2 trailing rec layers; we follow the model card's 38 layers with
pattern cycling), d_model=4096, 16 heads (GQA kv=1 => MQA) for the local
attention, d_ff=12288, vocab=256000. RG-LRU + local attention 1:2.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, RecurrentConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    ffn_dim=12288,
    vocab_size=256000,
    attention="local",
    sliding_window=2048,
    recurrent=RecurrentConfig(
        kind="rg_lru",
        lru_width=4096,
        conv1d_width=4,
        block_pattern=("rec", "rec", "attn"),
    ),
    source="arXiv:2402.19427",
)


def smoke():
    cfg = CONFIG.reduced(num_layers=2)
    return dataclasses.replace(
        cfg, recurrent=dataclasses.replace(cfg.recurrent,
                                           block_pattern=("rec", "attn")))
