"""Runtime support of the port: the span tracer and the ctypes binding
of the C++ optimizer state machine (native/swarm_state.cpp)."""
