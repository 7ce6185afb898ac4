"""Hub core of the port (this slice: the admission/wave scheduler
helpers the serving engine uses)."""
