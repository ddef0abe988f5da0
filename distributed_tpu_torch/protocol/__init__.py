"""Wire formats of the port."""
