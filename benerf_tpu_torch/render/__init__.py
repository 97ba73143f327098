"""render."""
