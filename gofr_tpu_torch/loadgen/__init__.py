"""Load-generation pieces of the port: the trace format and the
replica's trace export (ROADMAP A18b holds the rest)."""
