"""train."""
