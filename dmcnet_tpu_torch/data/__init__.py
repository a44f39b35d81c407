"""Data constants of the port."""
