"""Least time of the traced span's decode attention (every served
token's query over the positions it attended: their K and V rows read
once, q read and the output written once, ``work.counts`` at the HBM
bandwidth and the bf16 peak) over the split-KV decode kernels' device
time in the span. None where no such kernel ran (MLA decodes without
it) or the trace lost one of its events."""
from bench.work import counts, peaks

PATTERN = "decode_attention_"


def read(w):
    t = w.trace
    if t is None:
        return None
    device_s = t.kernel_s(PATTERN)
    lengths = [n for s in t.steps for _, n in s.tokens]
    if not device_s or not lengths:
        return None
    flops, nbytes = counts.decode_attention_work(w.served, lengths)
    least = w.served["num_layers"] * max(flops / peaks.BF16_FLOPS,
                                         nbytes / peaks.HBM_BYTES_PER_S)
    return 100.0 * least / device_s
