"""LDHT core for the port: topology (with its tree and pod tables),
Algorithm 1, the eight partitioners of ``api.METHODS`` (geoKM and the
Morton codes on the device, the refinement and the other methods host
NumPy), the tree-aware modes, the partition metrics and ``evaluate``."""
