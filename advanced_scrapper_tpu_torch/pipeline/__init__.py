"""Engines of the port."""
