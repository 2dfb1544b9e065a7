"""Training driver (PyTorch counterpart of ``repro.training.train_loop``):
the Markov data pipeline -> the eager train step -> logging and a
checkpoint."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, generator_for
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, MarkovTextDataset
from repro_torch.models import build_model
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.optimizer import AdamWConfig, init_opt_state


@dataclass
class TrainResult:
    losses: List[float] = field(default_factory=list)
    grad_norms: List[float] = field(default_factory=list)
    tokens_per_s: float = 0.0

    @property
    def final_loss(self) -> float:
        """The mean of the last 10 losses."""
        return float(np.mean(np.asarray(self.losses[-10:], np.float32)))


def train(cfg: ModelConfig, *, steps: int = 100, batch_size: int = 8,
          seq_len: int = 128, lr: float = 3e-4, seed: int = 0,
          ckpt_path: Optional[str] = None, log_every: int = 10,
          dtype=torch.float32, accum_steps: int = 1,
          log_fn: Callable[[str], None] = print,
          device: DeviceLike = None) -> TrainResult:
    """Train ``cfg`` from weights drawn with a generator seeded ``seed`` on
    the model's device, on Markov data of the same seed. ``device=None``
    means the card (raises without one). ``tokens_per_s`` counts every
    step, the data's host time included, up to a device sync."""
    from repro_torch.launch.steps import make_train_step  # import cycle
    model = build_model(cfg, dtype=dtype, device=device)
    params = model.init(generator_for(model.device, seed))
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 5),
                          total_steps=steps)
    opt_state = init_opt_state(params, opt_cfg)
    step_fn = make_train_step(model, opt_cfg, accum_steps=accum_steps)
    data = MarkovTextDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len, batch_size=batch_size,
        seed=seed))
    res = TrainResult()
    it = iter(data)
    t0 = time.perf_counter()
    for step in range(steps):
        batch = torch.from_numpy(next(it)).to(model.device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        res.losses.append(loss)
        res.grad_norms.append(float(metrics["grad_norm"]))
        if log_every and step % log_every == 0:
            log_fn(f"step {step:5d} loss {loss:.4f} "
                   f"gnorm {res.grad_norms[-1]:.3f}")
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    res.tokens_per_s = steps * batch_size * seq_len / (
        time.perf_counter() - t0)
    if ckpt_path:
        save_checkpoint(ckpt_path, {"params": params}, step=steps)
    log_fn(f"done: final loss {res.final_loss:.4f} "
           f"({res.tokens_per_s:.0f} tok/s); "
           f"data entropy floor {data.optimal_nll():.4f}")
    return res
