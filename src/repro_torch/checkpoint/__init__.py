"""Checkpoints of the trainer (counterpart of ``repro.checkpoint``)."""
