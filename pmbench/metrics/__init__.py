"""One reader a per-layer metric: ``pmbench/metrics/<metric>.py`` defines
``read(data: pmbench.trace.TraceData) -> float | None``; ``None`` when the
run has nothing for it to read (the harness then leaves it out).  The
program's own spans and counters are ``data.program``
(``pmbench.program_spans.ProgramTrace``)."""
