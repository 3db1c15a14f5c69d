"""Micro-batch assembly and the device engine."""
