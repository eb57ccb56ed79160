"""Disaggregation, the engine side: KV export, the KVT1 pull wire and inject
(port of ``llmd_tpu/disagg/transfer.py``), and the encode worker of E/PD and
E/P/D (port of ``llmd_tpu/disagg/encode.py``). The routing sidecar is not
ported: the reference's sidecar drives port encode workers and engines
unchanged."""
