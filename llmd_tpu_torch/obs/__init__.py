"""Observability: the metric families, the analytic cost model and
utilization / goodput ledger, tracing, the flight recorder and its phase and
decision ledgers, and the CUDA device plane."""
