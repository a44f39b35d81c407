"""Utilities of the port: the JSON-lines metrics log."""
