"""Observability of the port: the model health plane (`obs.health`).
The span trace of the JAX package's `obs/trace.py` (the `serve.*`,
`watch.*` and `fleet.*` spans) is ROADMAP A8.5."""
