"""Runtime pieces of the port: request intake and the error classes the
serving engine's recovery tells apart."""
