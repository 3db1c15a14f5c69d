"""Bucket-state constants shared by encode and the decide kernels."""
