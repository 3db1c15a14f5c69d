from gubernator_tpu_torch.store.store import (
    ItemSnapshot,
    Loader,
    MemoryLoader,
    MemoryStore,
    Store,
    attach_store,
    load_engine,
    merge_snapshots_lww,
    save_engine,
    snapshots_from_engine,
)

__all__ = [
    "ItemSnapshot",
    "Loader",
    "MemoryLoader",
    "MemoryStore",
    "Store",
    "attach_store",
    "load_engine",
    "merge_snapshots_lww",
    "save_engine",
    "snapshots_from_engine",
]
