"""Per-layer metric readers, one module per metric: ``read(records)``
returns the metric's value from a ``--trace 1`` run's records, or None when
there is nothing to read."""
