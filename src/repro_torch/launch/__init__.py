"""launch subpackage."""
