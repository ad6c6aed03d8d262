"""Sharding plans: logical axes resolved to DTensor placements on a mesh."""
