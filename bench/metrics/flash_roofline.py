"""Least time of the causal prefill attention the traced span's prompts
need in every layer (their real lengths, heads and head width from the configuration,
``work.counts.flash_work`` at the chip's peaks) over the flash kernel's
device time in the span. None when the span prefilled nothing or its
trace lost a flash event."""
from bench.work import counts, peaks

PATTERN = "flash_attention_"


def read(w):
    t = w.trace
    if t is None:
        return None
    device_s = t.kernel_s(PATTERN)
    # the prefill covers every prompt token but the last, which the
    # first decode step feeds
    lengths = [len(w.recs[k].spec.prompt) - 1
               for s in t.steps for k in s.admitted]
    if not device_s or not lengths:
        return None
    flops, nbytes = counts.flash_work(w.served, lengths)
    least = w.served["num_layers"] * max(flops / peaks.BF16_FLOPS,
                                         nbytes / peaks.HBM_BYTES_PER_S)
    return 100.0 * least / device_s
