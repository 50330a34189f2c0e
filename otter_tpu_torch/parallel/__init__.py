"""Device-wide work of the port (the pooled KDE)."""
