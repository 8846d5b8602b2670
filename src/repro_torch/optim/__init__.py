"""The optimizer and learning-rate schedules of the trainer (counterparts
of ``repro.optim``)."""
