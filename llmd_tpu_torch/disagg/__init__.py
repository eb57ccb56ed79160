"""P/D disaggregation, the engine side: KV export, the KVT1 pull wire and
inject (port of ``llmd_tpu/disagg/transfer.py``). The routing sidecar and the
encode stage are not ported: the reference's sidecar drives port engines
unchanged."""
