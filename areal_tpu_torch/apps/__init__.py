"""Entry points: the launcher and the command line."""
