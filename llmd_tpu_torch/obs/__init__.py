"""Observability: the analytic cost model and the utilization / goodput ledger."""
