"""The in-process V1 service over the device engine."""
