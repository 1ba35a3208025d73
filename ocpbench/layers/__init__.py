"""Per-layer metric readers, one module per metric family (the part of a
metric's name before its first dot).  Each has ``read(name, run)``, which
returns the metric's value or None where the run has nothing to read."""
