"""geometry."""
