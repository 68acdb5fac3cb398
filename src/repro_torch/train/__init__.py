"""train subpackage."""
