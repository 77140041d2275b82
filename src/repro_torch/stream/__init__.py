"""Synthetic stream sources."""
