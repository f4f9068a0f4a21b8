"""Observability of the port (the counterpart of ``tpulab.obs``):
standard-library metrics and tracing that the engine, the daemon and the
trainer record into.

* :mod:`~tpulab_torch.obs.registry`: the process-global ``Counter`` /
  ``Gauge`` / fixed-bucket ``Histogram`` registry with exemplars,
  copy-on-read snapshots and Prometheus text exposition;
* :mod:`~tpulab_torch.obs.tracer`: the preallocated ring-buffer tracer
  with Chrome trace-event export, and the process-unique request id
  (``next_rid``);
* :mod:`~tpulab_torch.obs.slowlog`: the worst-N per-request span
  summaries (the daemon's ``slowlog`` request);
* :mod:`~tpulab_torch.obs.journey`: rid-keyed phase marks stitched into
  one record per request (the daemon's ``journey`` request);
* :mod:`~tpulab_torch.obs.compilestats`: the ledger of run-time builds
  and the steady-state recompile tripwire;
* :mod:`~tpulab_torch.obs.roofline`: model flops, the card's peaks, MFU
  and the MFU and memory gauges;
* :mod:`~tpulab_torch.obs.flightrec`: one JSON post-mortem bundle per
  engine or replica failure (the daemon's ``postmortem`` request);
* :mod:`~tpulab_torch.obs.profiler`: ``torch.profiler`` traces and the
  ``[tag]`` event log;
* :mod:`~tpulab_torch.obs.history`: a fixed-capacity ring of registry
  snapshots with windowed rates and percentiles (the daemon's sampler and
  ``history`` request);
* :mod:`~tpulab_torch.obs.alerts`: the rule engine the sampler evaluates
  each tick (the daemon's ``alerts`` request);
* :mod:`~tpulab_torch.obs.render`: the terminal renderers of the live
  console (``python -m tpulab_torch.obs.console``).
"""

from tpulab_torch.obs.alerts import (ALERTS, AlertManager, BurnRateRule, Rule,
                                     ThresholdRule, default_rules,
                                     install_default_rules)
from tpulab_torch.obs.compilestats import (COMPILESTATS, CompileStats,
                                           RecompileError, note_build, strict)
from tpulab_torch.obs.flightrec import (configure_flightrec, latest_postmortem,
                                        record_postmortem)
from tpulab_torch.obs.history import (HISTORY, MetricsHistory, Sampler, Window,
                                      configure_history, counts_delta,
                                      fraction_le)
from tpulab_torch.obs.journey import (HANDOFF_PHASES, JOURNEY, PHASES, JourneyStore,
                                      configure_journey)
from tpulab_torch.obs.profiler import EventLog, annotate, maybe_trace
from tpulab_torch.obs.registry import (DEFAULT_BUCKETS, REGISTRY, Counter, Gauge,
                                       Histogram, Registry, counter, gauge,
                                       histogram, percentile_from_buckets,
                                       render_prometheus)
from tpulab_torch.obs.slowlog import SLOWLOG, SlowLog, configure_slowlog
from tpulab_torch.obs.tracer import (DEFAULT_CAPACITY, NULL, TRACER, Tracer,
                                     configure_tracer, event, next_rid, span)

__all__ = [
    "ALERTS", "AlertManager", "BurnRateRule", "HISTORY", "MetricsHistory",
    "Rule", "Sampler", "ThresholdRule", "Window", "configure_history",
    "counts_delta", "default_rules", "fraction_le", "install_default_rules",
    "COMPILESTATS", "DEFAULT_BUCKETS", "DEFAULT_CAPACITY", "HANDOFF_PHASES",
    "JOURNEY", "PHASES", "REGISTRY", "SLOWLOG", "CompileStats", "Counter",
    "EventLog", "Gauge", "Histogram", "JourneyStore", "NULL", "RecompileError",
    "Registry", "SlowLog", "TRACER", "Tracer", "annotate", "configure_flightrec",
    "configure_journey", "configure_slowlog", "configure_tracer", "counter",
    "event", "gauge", "histogram", "latest_postmortem", "maybe_trace",
    "next_rid", "note_build", "percentile_from_buckets", "record_postmortem",
    "render_prometheus", "span", "strict",
]
