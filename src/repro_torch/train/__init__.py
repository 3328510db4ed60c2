"""Training: AdamW, gradient compression and the fault-tolerant
``Trainer`` (the port of ``repro.train``)."""
