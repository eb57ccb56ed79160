"""Request and KV-event types shared by the engine (copies, no JAX)."""
