"""Surfel map data structures of the port."""
