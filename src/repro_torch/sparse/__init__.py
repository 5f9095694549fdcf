"""Sparse substrate for the port: CSR graphs and generators, the padded-COO
and block-ELL operators, the chunked CG, and the distributed plan with its
stacked single-GPU runtime."""
