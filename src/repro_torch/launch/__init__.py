"""Step builders and the serving CLI of the port (counterparts of
``repro.launch``)."""
