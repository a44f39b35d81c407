"""Utilities of the port: the JSON-lines metrics log (`metrics_log`),
flow pictures (`viz`) and profiling (`profiling`)."""
