"""Disaggregation: KV export, the KVT1 pull wire and inject (port of
``llmd_tpu/disagg/transfer.py``), the encode worker of E/PD and E/P/D (port of
``llmd_tpu/disagg/encode.py``), and the routing sidecar in front of a decode
engine that runs the P -> D (and E) legs (port of ``llmd_tpu/disagg/sidecar.py``)."""
