"""Telemetry of the port: the structured event stream and the serving
request spans (the JAX package's ``obs/``, the parts the engine calls)."""
