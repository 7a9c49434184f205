"""Plain PyTorch references that decide whether a run is ``correct``."""
