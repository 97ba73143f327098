"""data."""
