"""Collectives over the mesh's axes."""
