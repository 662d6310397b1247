"""Database sharding over cards and processes (``parallel.dist``)."""
