"""Deployment helpers: the stream mesh of ``placement="mesh"``."""
