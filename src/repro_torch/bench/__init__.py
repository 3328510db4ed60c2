"""Benchmarks of the port and their regression gate."""
