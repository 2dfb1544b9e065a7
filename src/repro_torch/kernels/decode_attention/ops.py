"""Public wrapper of ragged decode attention: dispatch by the tensors'
device. A CPU tensor takes the plain version; a CUDA tensor launches the
hand-written kernel or raises."""
from __future__ import annotations

import torch

from repro_torch.kernels import check_cuda_operands
from repro_torch.kernels.decode_attention import kernel
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def decode_attention(q, k_cache, v_cache, lengths):
    """q: [B,H,D]; k/v_cache: [B,C,Kv,D]; lengths: int [B] -> [B,H,D].

    ``lengths[b]`` is the number of leading cache positions row b attends
    over (the KV ledger's context length, clamped to [0, C]); 0 yields a
    zero output row. Any C runs: the kernel masks the ragged last tile.
    """
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lengths)
    B, H, D = q.shape
    if k_cache.dim() != 4 or k_cache.shape[0] != B or k_cache.shape[3] != D:
        raise ValueError(f"k_cache {tuple(k_cache.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if v_cache.shape != k_cache.shape:
        raise ValueError("k_cache and v_cache differ in shape")
    Kv = k_cache.shape[2]
    if H % Kv or H // Kv > kernel.MAX_GROUP \
            or (H // Kv) * D > kernel.MAX_GROUP_WIDTH:
        raise ValueError(f"unsupported GQA group: H={H}, Kv={Kv}, D={D}")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError("lengths must be int32 [B]")
    check_cuda_operands("decode_attention", q, k_cache, v_cache,
                        index=(lengths,))
    out = torch.empty_like(q)
    kernel.decode_attention_cuda(q, k_cache, v_cache, lengths, out)
    decode_attention.launches += 1
    return out


#: kernel launches (plain-version calls on CPU tensors do not count)
decode_attention.launches = 0
