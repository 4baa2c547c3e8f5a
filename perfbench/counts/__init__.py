"""Operation and byte counts behind the roofline shares and ``mfu``."""
