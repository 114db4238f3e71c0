"""Flight recorder: opt-in per-round trace capture for the engine (port
of ``repro.trace``).

``EngineConfig(trace=True, trace_every=k, trace_rounds=R)`` makes the
engine fill a :class:`TraceBuf` ring as it runs: per-channel msgs /
spills / queue depth, per-tile busy cycles and the round's critical-path
tile, flits per link class, the TSU's budgets, the streamed windows, the
frontier and the pending work, every k-th round, bounded by the R-slot
ring.  Trace-off adds nothing to a round; trace-on never changes values
or ``Stats``.

Consumers (:mod:`repro_torch.trace.export`): Chrome/Perfetto trace JSON
on the modelled-cycle timeline, a JSONL round stream, and the
utilization / work-imbalance / queue-depth summary.  CLI::

    python -m repro_torch.trace summarize [--preset rmat-small]
    python -m repro_torch.trace export --out run.perfetto.json
"""
from repro_torch.trace.buffer import (SERIES_FIELDS, TraceBuf, record_round,
                                      zero_trace)
from repro_torch.trace.export import (LINK_CLASS_NAMES, format_summary,
                                      jsonl_rows, lane_trace,
                                      reconcile_cycles, summarize,
                                      to_perfetto, trace_arrays,
                                      trace_metrics, utilization, work_cov,
                                      write_jsonl, write_perfetto)

__all__ = [
    "TraceBuf", "SERIES_FIELDS", "record_round", "zero_trace",
    "LINK_CLASS_NAMES", "format_summary", "jsonl_rows", "lane_trace",
    "reconcile_cycles", "summarize", "to_perfetto", "trace_arrays",
    "trace_metrics", "utilization", "work_cov", "write_jsonl",
    "write_perfetto",
]
