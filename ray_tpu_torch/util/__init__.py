"""Runtime utilities of the port (scheduling strategies)."""
