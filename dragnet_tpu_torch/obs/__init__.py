"""Observability seams of the port: typed metrics (`metrics`) and the
span hooks (`trace`) that the index build and publish path call.
Counterpart of dragnet_tpu/obs, without its exports and events journal.
"""
