"""Model code of the port: layers, the dense transformer and the model
facade (counterparts of ``repro.models``)."""
