"""Serving steps: prefill and single-token decode under a sharding plan."""
