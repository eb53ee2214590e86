"""Sparse containers, ingest and golden models (the port's own copy of the
JAX package's ``formats/``: ``csr``, ``gold``, ``random``, ``io``)."""
