"""Correctness tooling of the port: the lock-order witness (stdlib only,
so the lowest layers, `core.store` and `obs`, import it without cycles)."""
