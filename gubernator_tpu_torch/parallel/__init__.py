"""Multi-shard tiers: the owner-sharded mesh (mesh.py)."""
