"""Sparse containers, ingest and golden models (the port's own copy of the
JAX package's ``formats/``: ``csr``, ``gold``, ``random``, ``io``,
``convert``)."""

from .convert import bsr_to_csr, coo_to_csr, csr_to_bsr, csr_to_coo

__all__ = ["bsr_to_csr", "coo_to_csr", "csr_to_bsr", "csr_to_coo"]
