"""Numeric helpers of the port (counterparts of ``repro.core``)."""
