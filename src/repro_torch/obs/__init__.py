"""Observability (PyTorch counterpart of ``repro.obs``): span tracing,
executed-vs-scheduled overlap attribution, and a metrics registry.

  * ``trace``    — ``TraceRecorder``: host spans on a monotonic clock
                   (engine phases, request lifecycles, the DEP walk's
                   task emissions) and, in device mode, the walk's tasks
                   timed on the card by CUDA event pairs on the comm and
                   compute streams;
  * ``export``   — Chrome-trace/Perfetto JSON (a copy, plus a track
                   group for device spans) and its schema validator;
  * ``overlap``  — interval algebra, lane occupancy and exposed comm,
                   executed against scheduled (a copy);
    ``replay``   — a scheduled graph run on four host lanes;
    ``device``   — one DEP layer's executed task spans;
  * ``metrics``  — ``Counter``/``Gauge``/``Histogram`` behind one
                   ``MetricsRegistry`` (a copy).

``metrics``, ``export`` and ``overlap`` are copies of the reference's
modules; ``trace``, ``replay`` and ``device`` are written for torch.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, log_buckets,
                                     parse_prometheus)
from repro_torch.obs.trace import (Span, TraceRecorder, active_tracer,
                                   use_tracer)
from repro_torch.obs.export import (chrome_trace, export_chrome_trace,
                                    validate_chrome_trace)
from repro_torch.obs.overlap import (LaneOccupancy, OverlapReport,
                                     attribute_overlap,
                                     executed_exposed_comm, interval_total,
                                     interval_subtract, interval_union,
                                     lane_intervals)
from repro_torch.obs.replay import ReplayResult, replay_schedule
from repro_torch.obs.device import (DeviceTrace, device_mesh,
                                    trace_dep_execution)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "log_buckets",
    "parse_prometheus",
    "Span", "TraceRecorder", "active_tracer", "use_tracer",
    "chrome_trace", "export_chrome_trace", "validate_chrome_trace",
    "LaneOccupancy", "OverlapReport", "attribute_overlap",
    "executed_exposed_comm", "interval_total", "interval_subtract",
    "interval_union", "lane_intervals",
    "ReplayResult", "replay_schedule",
    "DeviceTrace", "device_mesh", "trace_dep_execution",
]
