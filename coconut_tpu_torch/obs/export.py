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
    its span. `ts` is on the Unix epoch (the tracer's `anchor`), the
    clock of torch.profiler's events. Given the file a profiler's
    `export_chrome_trace` wrote, `write_chrome` / `export_chrome` write
    that document with the spans added on its time base (its `ts` count
    from its `baseTimeNanoseconds`), so one Perfetto view holds both.

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


def _anchor(spans):
    """(clock reading, time_ns) of the tracer that recorded `spans`, from
    the first Span; (0, 0), the raw clock, for bare records (read back
    from JSONL, say), whose tracer is not known."""
    for s in spans:
        if isinstance(s, _trace.Span):
            return s._tracer.anchor
    return (0.0, 0)


def chrome_events(spans, pid=1):
    """Chrome trace_events list for finished spans: one "X" (complete)
    event per span plus one "i" (instant) event per span event, sorted by
    ts so the stream is monotonic; ts in microseconds on the Unix epoch.
    Live (unfinished) spans are skipped — an X event needs a dur."""
    mono0, ns0 = _anchor(spans)

    def us(t):
        return ns0 / 1e3 + (t - mono0) * _US

    events = []
    for rec in span_records(spans):
        if rec["dur"] is None:
            continue
        ts = us(rec["t0"])
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
                    "ts": us(ev.pop("ts")),
                    "s": "t",
                    "pid": pid,
                    "tid": rec["tid"],
                    "args": {"trace_id": rec["trace_id"], **ev},
                }
            )
    events.sort(key=lambda e: e["ts"])
    return events


def write_chrome(spans, path, pid=1, profiler_trace=None):
    """Write the Perfetto-loadable JSON document; returns the count of
    the spans' events. With `profiler_trace`, the path of a
    torch.profiler `export_chrome_trace` file, the document is that
    file's with the spans' events added on its `baseTimeNanoseconds`
    (give `pid=os.getpid()` to put them beside its host threads)."""
    doc = {"traceEvents": [], "displayTimeUnit": "ms"}
    if profiler_trace is not None:
        with open(profiler_trace) as f:
            doc = json.load(f)
    events = chrome_events(spans, pid=pid)
    base_us = doc.get("baseTimeNanoseconds", 0) / 1e3
    for e in events:
        e["ts"] -= base_us
    doc["traceEvents"] = doc["traceEvents"] + events
    # lint: allow(durability, on-demand trace export artifact - rewritten
    # whole per call, nothing re-reads it across a crash)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(events)


def export_chrome(path, tracer=None, pid=1, profiler_trace=None):
    """Dump the (global) tracer's finished-span ring as Chrome trace JSON,
    into a copy of `profiler_trace` if given (`write_chrome`); returns the
    event count (0, writing an empty-but-valid document, when tracing is
    disabled)."""
    tracer = tracer if tracer is not None else _trace.get_tracer()
    spans = tracer.tail() if tracer is not None else []
    return write_chrome(spans, path, pid=pid, profiler_trace=profiler_trace)


def export_jsonl(path, tracer=None):
    """Dump the (global) tracer's finished-span ring as JSONL; returns
    the record count."""
    tracer = tracer if tracer is not None else _trace.get_tracer()
    spans = tracer.tail() if tracer is not None else []
    return write_jsonl(spans, path)
