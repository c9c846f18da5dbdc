"""Minimal XES XML interop (the IEEE-standard format of the paper §2).

Intentionally simple: traces > events > string/int/float/date attributes.
XES is row-structured XML — its size/parse overheads versus EDF columns are
exactly the Table 1/2 comparison of the paper.

Timestamps are serialized as the XES-standard ``<date>`` attribute in
ISO-8601 with an explicit UTC offset (``1970-01-01T00:00:12.500000+00:00``)
rather than a raw epoch float — what PM4Py/ProM expect — and parsed back
to epoch seconds on read (a trailing ``Z`` offset is accepted too).
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from datetime import datetime, timezone
from xml.sax.saxutils import quoteattr

from repro_torch.core.classic_log import ClassicEventLog
from repro_torch.core.eventframe import ACTIVITY, CASE, TIMESTAMP


def _iso8601(epoch: float) -> str:
    return datetime.fromtimestamp(float(epoch), tz=timezone.utc).isoformat()


def _epoch(iso: str) -> float:
    if iso.endswith("Z"):
        iso = iso[:-1] + "+00:00"
    dt = datetime.fromisoformat(iso)
    if dt.tzinfo is None:        # naive timestamps are taken as UTC
        dt = dt.replace(tzinfo=timezone.utc)
    return dt.timestamp()


def write(path: str, log: ClassicEventLog) -> None:
    by_case: dict = {}
    for e in log.events:
        by_case.setdefault(e[CASE], []).append(e)
    with open(path, "w") as f:
        f.write('<?xml version="1.0" encoding="UTF-8" ?>\n<log xes.version="1.0">\n')
        for cid, evs in by_case.items():
            # quoteattr (not escape): escape() leaves " untouched, which
            # breaks value="..." for values containing quotes
            f.write(f'  <trace>\n    <string key="concept:name" value={quoteattr(str(cid))}/>\n')
            for e in evs:
                f.write("    <event>\n")
                for k, v in e.items():
                    if k == CASE:
                        continue
                    if k == TIMESTAMP and isinstance(v, (int, float)):
                        f.write(f'      <date key={quoteattr(k)} '
                                f'value={quoteattr(_iso8601(v))}/>\n')
                        continue
                    tag = "int" if isinstance(v, int) else "float" if isinstance(v, float) else "string"
                    f.write(f'      <{tag} key={quoteattr(k)} value={quoteattr(str(v))}/>\n')
                f.write("    </event>\n")
            f.write("  </trace>\n")
        f.write("</log>\n")


def read(path: str) -> ClassicEventLog:
    tree = ET.parse(path)
    events = []
    order = 0
    for trace in tree.getroot().iter("trace"):
        cid = None
        for child in trace:
            if child.tag == "string" and child.get("key") == "concept:name":
                cid = child.get("value")
        for ev in trace.iter("event"):
            e = {CASE: cid}
            for a in ev:
                k, v = a.get("key"), a.get("value")
                if a.tag == "int":
                    e[k] = int(v)
                elif a.tag == "float":
                    e[k] = float(v)
                elif a.tag == "date":
                    e[k] = _epoch(v)
                else:
                    e[k] = v
            e.setdefault(TIMESTAMP, float(order))
            events.append(e)
            order += 1
    events.sort(key=lambda e: e[TIMESTAMP])
    return ClassicEventLog(events)
