"""Step factories and launchers (the port of ``repro.launch``)."""
