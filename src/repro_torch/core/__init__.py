"""LDHT core for the port: topology (with its tree and pod tables),
Algorithm 1, geoKM, the partition metrics and the ``partition`` entry point
(flat path)."""
