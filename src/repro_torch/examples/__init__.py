"""Runnable demonstrations of the port (counterparts of ``examples/``)."""
