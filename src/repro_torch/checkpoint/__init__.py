"""Object-store checkpoints (the port of ``repro.checkpoint``)."""
