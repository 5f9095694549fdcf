"""LDHT core for the port: topology, Algorithm 1, geoKM and the
``partition`` entry point (flat path)."""
