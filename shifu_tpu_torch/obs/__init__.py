"""Observability of the port: the span tracer (`obs.trace`) and the
model health plane (`obs.health`)."""
