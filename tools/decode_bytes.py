#!/usr/bin/env python3
"""The bytes a decode step of a served path must move, and the least time
they take at the H100's 3.35 TB/s: the layers' weights in bf16 (an MoE
layer reads every expert at decode), K/V at 8 slots of ``--context``
positions, and the f32 readout as ``Model._readout`` computes it (the
table read in bf16, written in f32 and read back: 10 bytes a value),
beside the table read once in bf16. Shapes only: the model is built on
the ``meta`` device, so it runs anywhere.

Run:  PYTHONPATH=src python3 tools/decode_bytes.py [--context 300]
"""
import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.launch.steps import make_model
from repro_torch.models.layers import MetaGenerator

HBM_BYTES_PER_S = 3.35e12
#: chip_smoke's served paths: config, layers served
PATHS = {"granite": ("granite-moe-1b-a400m", 24),
         "qwen2-1.5b": ("qwen2-1.5b", 28),
         "starcoder2": ("starcoder2-3b", 30),
         "command-r": ("command-r-35b", 16)}


def numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(numel(v) for v in tree)
    return tree.numel()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--context", type=int, default=300)
    args = ap.parse_args()
    for path, (arch, layers) in PATHS.items():
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        params = make_model(cfg, None, device="meta").init(MetaGenerator())
        weights = 2 * (numel(params["layers"])
                       + numel(params.get("lm_head", {})))
        kv = layers * 8 * args.context * 2 * cfg.num_kv_heads \
            * cfg.head_dim * 2
        table = cfg.vocab_size * cfg.d_model
        readout = 10 * table
        total = weights + kv + readout

        def ms(b):
            return b / HBM_BYTES_PER_S * 1e3
        print(f"{path} ({arch}, {layers} layers): weights {weights / 1e9:.2f}"
              f" GB {ms(weights):.3f} ms; K/V {kv / 1e9:.3f} GB "
              f"{ms(kv):.3f} ms; readout {readout / 1e9:.2f} GB "
              f"{ms(readout):.3f} ms (the table once in bf16 "
              f"{ms(2 * table):.3f} ms); step {total / 1e9:.2f} GB "
              f"{ms(total):.3f} ms, readout {readout / total:.1%}")


if __name__ == "__main__":
    main()
