"""parallel."""
