"""Plain PyTorch version of the grouped expert FFN (paper Eq. 3):
per expert e: y_e = silu(x_e @ Wg_e) * (x_e @ Wu_e) @ Wd_e."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def moe_gemm_ref(x, w_gate, w_up, w_down):
    """x: [E, C, M]; w_gate/w_up: [E, M, H]; w_down: [E, H, M] -> [E, C, M].
    Accumulation in float32, output in x.dtype."""
    xf = x.float()
    g = torch.einsum("ecm,emh->ech", xf, w_gate.float())
    u = torch.einsum("ecm,emh->ech", xf, w_up.float())
    y = torch.einsum("ech,ehm->ecm", F.silu(g) * u, w_down.float())
    return y.to(x.dtype)
