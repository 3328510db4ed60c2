"""Training data (the port of ``repro.data``)."""
