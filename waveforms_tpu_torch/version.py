"""Package version (kept importable without heavy dependencies)."""
__version__ = "0.3.0"
