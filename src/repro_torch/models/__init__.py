"""Model families of the port (this slice: the dense transformer)."""
