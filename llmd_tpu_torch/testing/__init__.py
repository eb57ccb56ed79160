"""Test and smoke-run helpers of the port (HF checkpoints written locally)."""
