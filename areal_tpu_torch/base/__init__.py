"""Process-level helpers: env knobs and device resolution."""
