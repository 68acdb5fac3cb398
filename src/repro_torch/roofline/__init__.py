"""roofline subpackage."""
