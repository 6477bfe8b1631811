"""Readers of the per-layer metrics, one module a metric, named as the
metric (dots and dashes as underscores).  Each has `read(trace)`, which
returns the metric's value from the traced run (tracing.Trace, with
`frames`, `calls` and `card` set by the harness), or None where the
trace holds nothing for it to read."""
