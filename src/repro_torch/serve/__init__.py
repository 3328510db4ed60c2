"""Batched LLM serving (the port of ``repro.serve.engine``)."""
