"""Logical-axis sharding of the port over a ``torch`` ``DeviceMesh``."""
