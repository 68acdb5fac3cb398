"""distributed subpackage."""
