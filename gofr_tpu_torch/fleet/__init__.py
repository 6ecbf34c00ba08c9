"""Fleet pieces of the port: prefix affinity (the router waits in
ROADMAP A18b)."""
