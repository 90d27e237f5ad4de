"""Structured dead-letter JSONL schema validation.

A shell gate could assert the dead-letter contract with a chain of
``grep -q '"schema": 4'``-style probes — which pass on a file whose keys
carry the wrong types, miss records entirely, or hold torn garbage after
the matched line. This module IS the contract, executable:

    python -m coconut_tpu_torch.analysis.schema <dead.jsonl> \
        --expect batch=1 --expect credential=2

validates that every line parses, carries exactly the schema-v4 key set
with the right types (null-ability per faults.DeadLetterLog.read's
normalization contract), and that at least one record matches each
``--expect field=value`` probe. Exit status is the gate.

It is also importable (validate_record / validate_file) — the faults
tests and the analysis fixture suite use it directly.
"""

import json
import sys

DEAD_LETTER_SCHEMA = 4

#: field -> (types allowed, nullable)
_FIELDS = {
    "schema": ((int,), False),
    "batch": ((int,), False),
    "credential": ((int,), False),
    "reason": ((str,), False),
    "attempts": ((list,), False),
    "trace_id": ((str,), True),
    "span_id": ((str,), True),
    "program": ((str,), True),
    "nullifier": ((str,), True),
}


def validate_record(rec, lineno=None):
    """List of problem strings for one decoded record (empty = valid)."""
    where = "" if lineno is None else "line %d: " % lineno
    problems = []
    if not isinstance(rec, dict):
        return ["%srecord is %s, not an object" % (where, type(rec).__name__)]
    for field, (types, nullable) in _FIELDS.items():
        if field not in rec:
            problems.append("%smissing key %r" % (where, field))
            continue
        val = rec[field]
        if val is None:
            if not nullable:
                problems.append("%skey %r must not be null" % (where, field))
            continue
        if isinstance(val, bool) or not isinstance(val, types):
            problems.append(
                "%skey %r has type %s, expected %s"
                % (
                    where,
                    field,
                    type(val).__name__,
                    "/".join(t.__name__ for t in types),
                )
            )
    for extra in sorted(set(rec) - set(_FIELDS)):
        problems.append("%sunexpected key %r" % (where, extra))
    if not problems and rec["schema"] != DEAD_LETTER_SCHEMA:
        problems.append(
            "%sschema %r != %d" % (where, rec["schema"], DEAD_LETTER_SCHEMA)
        )
    if not problems and (rec["batch"] < 0 or rec["credential"] < 0):
        problems.append("%snegative batch/credential index" % where)
    return problems


def validate_file(path, expectations=()):
    """(records, problems): parse + validate every line, then check each
    (field, value) expectation matches at least one record."""
    problems = []
    records = []
    with open(path, "r", encoding="utf-8") as f:
        for lineno, line in enumerate(f, start=1):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                problems.append("line %d: unparseable JSON" % lineno)
                continue
            problems.extend(validate_record(rec, lineno))
            records.append(rec)
    if not records:
        problems.append("no records in %s" % path)
    for field, value in expectations:
        if not any(r.get(field) == value for r in records):
            problems.append(
                "no record with %s == %r among %d records"
                % (field, value, len(records))
            )
    return records, problems


def _parse_expect(raw):
    field, _, val = raw.partition("=")
    if not field or not _:
        raise SystemExit("--expect wants field=value, got %r" % raw)
    try:
        value = int(val)
    except ValueError:
        value = val
    return field, value


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    expectations = []
    paths = []
    i = 0
    while i < len(argv):
        if argv[i] == "--expect":
            expectations.append(_parse_expect(argv[i + 1]))
            i += 2
        elif argv[i].startswith("--expect="):
            expectations.append(_parse_expect(argv[i].split("=", 1)[1]))
            i += 1
        else:
            paths.append(argv[i])
            i += 1
    if not paths:
        raise SystemExit("usage: analysis.schema <dead.jsonl> [--expect f=v]")
    rc = 0
    for path in paths:
        records, problems = validate_file(path, expectations)
        if problems:
            rc = 1
            for p in problems:
                print("%s: %s" % (path, p))
        else:
            print(
                "%s: %d dead-letter records, schema v%d ok"
                % (path, len(records), DEAD_LETTER_SCHEMA)
            )
    return rc


if __name__ == "__main__":
    sys.exit(main())
