"""Observability of the port: typed metrics (`metrics`), per-request
span trees (`trace`), their Prometheus and /stats exports (`export`)
and the event journal (`events`).  Counterpart of dragnet_tpu/obs,
without its metric history rings (obs/history.py).
"""
