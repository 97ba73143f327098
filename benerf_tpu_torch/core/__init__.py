"""core."""
