"""Train a small MoE LM for a few hundred steps on synthetic Markov data
(loss drops toward the data's entropy floor), then checkpoint: the
PyTorch counterpart of ``examples/train_small.py``, with the same presets,
flags and printed summary.

Presets:  --preset tiny   (~4M params,  fast CI run; default)
          --preset 100m   (~100M params, a few hundred steps — the full
                           deliverable run)

Flags of the port's own:

  --device DEV     where to train (default: the CUDA card; "cpu" for the
                   plain versions)

The model trains in float32 under ``attn_impl="xla"`` and the capacity
MoE path, as the reference's ``train`` does: the experts run through the
expert GEMM kernel (its f32 SIMT kernel on the card) and its backward.
The checkpoint (``--ckpt``, default ``repro_torch_ckpt`` in the temporary
directory) is in the reference's format.

Run:  python -m repro_torch.launch.train_small --device cpu --steps 20
      python -m repro_torch.launch.train_small --preset 100m --steps 200
(with ``src`` on ``PYTHONPATH``).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.training import TrainResult, train

PRESETS = {
    "tiny": ModelConfig(
        name="tiny-moe", family="moe", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=2, ffn_dim=0, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, expert_ffn_dim=256,
                      num_shared_experts=1, shared_ffn_dim=256)),
    "100m": ModelConfig(
        name="moe-100m", family="moe", num_layers=12, d_model=512,
        num_heads=8, num_kv_heads=4, ffn_dim=0, vocab_size=32000,
        moe=MoEConfig(num_experts=8, top_k=2, expert_ffn_dim=1024,
                      num_shared_experts=1, shared_ffn_dim=1024)),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", choices=PRESETS, default="tiny")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the plain "
                         "versions")
    return ap


def main(argv=None) -> TrainResult:
    args = build_parser().parse_args(argv)
    cfg = PRESETS[args.preset]
    print(f"training {cfg.name}: ~{cfg.num_params()/1e6:.1f}M params, "
          f"{args.steps} steps, batch {args.batch} x {args.seq}")
    res = train(cfg, steps=args.steps, batch_size=args.batch,
                seq_len=args.seq, lr=args.lr, ckpt_path=args.ckpt,
                log_every=max(args.steps // 20, 1), device=args.device)
    print(f"loss {res.losses[0]:.3f} -> {res.final_loss:.3f} "
          f"({res.tokens_per_s:.0f} tokens/s); checkpoint at {args.ckpt}")
    return res


if __name__ == "__main__":
    main()
