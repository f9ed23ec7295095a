"""Observability of the port: typed metrics (`metrics`), per-request
span trees (`trace`), their Prometheus and /stats exports (`export`),
the event journal (`events`) and the metric history rings (`history`).
Counterpart of dragnet_tpu/obs.
"""
