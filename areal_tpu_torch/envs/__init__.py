"""Environment services."""
