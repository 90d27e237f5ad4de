"""Trace export: JSONL span records and Chrome-trace/Perfetto JSON.

Two serializations of the same ring buffer, for two consumers:

  - JSONL (`write_jsonl`): one span object per line, the same schema the
    flight recorder embeds — greppable, streamable, joins against the
    dead-letter log on trace_id.
  - Chrome trace events (`write_chrome`): the `{"traceEvents": [...]}`
    format Perfetto (https://ui.perfetto.dev) and chrome://tracing open
    directly. Spans become complete ("ph": "X") events with microsecond
    ts/dur; span events become instant ("ph": "i") events on the same
    thread track, so a retry or bisection split shows up as a tick inside
    its span.

Span args carry trace_id/span_id/parent_id, so tooling can rebuild the
tree: events are
sorted by ts, and within one parent the children's summed dur never
exceeds the parent's dur (children are sequential stages of their
parent's lifetime).
"""

import json

from . import trace as _trace

_US = 1e6  # chrome trace events are denominated in microseconds


def span_records(spans):
    """JSON-ready dicts for Span objects (dicts pass through), t0 order."""
    recs = [s if isinstance(s, dict) else s.to_dict() for s in spans]
    return sorted(recs, key=lambda r: (r["t0"], r["span_id"]))


def write_jsonl(spans, path):
    """One span record per line; returns the record count."""
    recs = span_records(spans)
    # lint: allow(durability, on-demand trace export artifact - rewritten
    # whole per call, nothing re-reads it across a crash)
    with open(path, "w") as f:
        for rec in recs:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
    return len(recs)


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def chrome_events(spans, pid=1):
    """Chrome trace_events list for finished spans: one "X" (complete)
    event per span plus one "i" (instant) event per span event, sorted by
    ts so the stream is monotonic. Live (unfinished) spans are skipped —
    an X event needs a dur."""
    events = []
    for rec in span_records(spans):
        if rec["dur"] is None:
            continue
        ts = rec["t0"] * _US
        events.append(
            {
                "name": rec["name"],
                "ph": "X",
                "ts": ts,
                "dur": rec["dur"] * _US,
                "pid": pid,
                "tid": rec["tid"],
                "args": {
                    "trace_id": rec["trace_id"],
                    "span_id": rec["span_id"],
                    "parent_id": rec["parent_id"],
                    **rec["attrs"],
                },
            }
        )
        for ev in rec["events"]:
            ev = dict(ev)
            events.append(
                {
                    "name": "%s.%s" % (rec["name"], ev.pop("name")),
                    "ph": "i",
                    "ts": ev.pop("ts") * _US,
                    "s": "t",
                    "pid": pid,
                    "tid": rec["tid"],
                    "args": {"trace_id": rec["trace_id"], **ev},
                }
            )
    events.sort(key=lambda e: e["ts"])
    return events


def write_chrome(spans, path, pid=1):
    """Write the Perfetto-loadable JSON document; returns the event
    count."""
    events = chrome_events(spans, pid=pid)
    # lint: allow(durability, on-demand trace export artifact - rewritten
    # whole per call, nothing re-reads it across a crash)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(events)


def export_chrome(path, tracer=None, pid=1):
    """Dump the (global) tracer's finished-span ring as Chrome trace JSON;
    returns the event count (0, writing an empty-but-valid document, when
    tracing is disabled)."""
    tracer = tracer if tracer is not None else _trace.get_tracer()
    spans = tracer.tail() if tracer is not None else []
    return write_chrome(spans, path, pid=pid)


def export_jsonl(path, tracer=None):
    """Dump the (global) tracer's finished-span ring as JSONL; returns
    the record count."""
    tracer = tracer if tracer is not None else _trace.get_tracer()
    spans = tracer.tail() if tracer is not None else []
    return write_jsonl(spans, path)
