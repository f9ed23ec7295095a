"""Observability seams of the port: typed metrics (`metrics`), the
span hooks (`trace`) that the index build and publish path call, and
the event journal (`events`).  Counterpart of dragnet_tpu/obs, without
its exports and history rings.
"""
