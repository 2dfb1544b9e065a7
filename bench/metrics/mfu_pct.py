"""The whole serving step's share of the chip's bf16 peak: the model
FLOPs of the window's work (each prompt prefilled in the window, each
token served in it at its context: projections, router, top-k routed
and shared experts, attention, the readout; ``work.counts``) over the
window's seconds at 989 TFLOP/s."""
from bench.work import counts, peaks


def read(w):
    flops = 0
    for s in w.steps:
        for k in s.admitted:
            flops += counts.prefill_flops(w.served,
                                          len(w.recs[k].spec.prompt) - 1)
        for _, n in s.tokens:
            flops += counts.decode_flops(w.served, n)
    if not flops:
        return None
    return 100.0 * flops / (w.seconds * peaks.BF16_FLOPS)
