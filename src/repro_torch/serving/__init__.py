"""serving subpackage: the split-execution engines (``engine``)."""
