"""xlstm-1.3b [ssm] — xLSTM: Extended Long Short-Term Memory
[arXiv:2405.04517].

48L, d_model=2048, 4 heads (kv=4), d_ff=0 (FFN inside blocks), vocab=50304.
sLSTM + mLSTM blocks at 7:1 (mLSTM:sLSTM), per the paper's xLSTM[7:1].
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, RecurrentConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    ffn_dim=0,
    vocab_size=50304,
    attention="none",
    recurrent=RecurrentConfig(
        kind="mlstm",
        block_pattern=("mlstm",) * 7 + ("slstm",),
    ),
    source="arXiv:2405.04517",
)


def smoke():
    cfg = CONFIG.reduced(num_heads=2, num_kv_heads=2)
    return dataclasses.replace(
        cfg, recurrent=dataclasses.replace(
            cfg.recurrent, block_pattern=("mlstm", "slstm")))
