"""Data parallelism (``mesh.py``): the counterpart of ``plnerf/parallel``."""
