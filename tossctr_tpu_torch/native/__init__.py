"""Host-side native code of the port: the threaded row gather the shard
cache's loader uses on every batch (``fastgather.cpp``, built by
``build.py`` at first use)."""

from .build import (
    gather_counts,
    gather_rows_multi,
    library_path,
    load_fastgather,
    reset_gather_counts,
)

__all__ = ["gather_counts", "gather_rows_multi", "library_path", "load_fastgather",
           "reset_gather_counts"]
