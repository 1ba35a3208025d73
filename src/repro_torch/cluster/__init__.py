"""The memory tiers in front of a `CuboidStore`: the hot-cuboid cache and
the write-behind queue (the rest of the reference's `cluster` package is
not ported yet)."""
from .cache import (CuboidCache, WriteBehindQueue, attach_cache,  # noqa: F401
                    enable_write_behind)

__all__ = ["CuboidCache", "WriteBehindQueue", "attach_cache", "enable_write_behind"]
