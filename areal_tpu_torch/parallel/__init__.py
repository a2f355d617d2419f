"""Parallelism config (one device so far)."""
