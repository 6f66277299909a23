"""Entry points of the port (``repro.launch``): serving so far."""
