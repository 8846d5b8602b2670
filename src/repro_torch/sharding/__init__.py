"""Logical-axis sharding of the port (counterpart of ``repro.sharding``):
the rule tables and the tensor-parallel serving helpers over
``torch.distributed``."""
