"""Per-layer metrics, one reader a file (``readers.py``)."""
