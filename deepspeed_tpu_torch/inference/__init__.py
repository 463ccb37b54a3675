"""Inference (serving) for the port: the ragged v2 engine."""
