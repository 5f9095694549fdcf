"""Sparse substrate for the port: CSR graphs and generators, the padded-COO
and block-ELL operators, the chunked CG, and the flat and tree distributed
plans with their stacked single-GPU runtime."""
