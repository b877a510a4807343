"""Default configs of the port."""
