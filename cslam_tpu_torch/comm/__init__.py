"""Swarm communication of the port: typed wire messages, the in-process
pub/sub bus, neighbor liveness and broker election, simulated
rendezvous fault injection. Pure Python and numpy."""
