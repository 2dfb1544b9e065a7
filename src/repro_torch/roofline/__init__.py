"""Roofline of a step on the NVIDIA H100, counted from the ops it
dispatches (the counterpart of ``repro.roofline``)."""
from repro_torch.roofline.analysis import (COLLECTIVE_KINDS, HBM_BW,
                                           HOST_CARDS, NET_BW, NVLINK_BW,
                                           PEAK_FLOPS, TF32_FLOPS, Counts,
                                           Roofline, StepCounter, analyze,
                                           model_flops, wire_bytes)

__all__ = ["COLLECTIVE_KINDS", "Counts", "HBM_BW", "HOST_CARDS", "NET_BW",
           "NVLINK_BW", "PEAK_FLOPS", "Roofline", "StepCounter",
           "TF32_FLOPS", "analyze", "model_flops", "wire_bytes"]
