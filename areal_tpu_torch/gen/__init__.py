"""Generation side of the port: page accounting, sampling, the
continuous-batching engine and its HTTP server."""
