"""Sharding: the logical-axis rule tables (``rules``) and their execution
over a mesh of processes (``fsdp``)."""
