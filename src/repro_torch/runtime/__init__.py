"""Fault tolerance of the training loop (counterpart of ``repro.runtime``)."""
