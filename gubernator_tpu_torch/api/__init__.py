"""Request/response types and key hashing."""
