"""Inference engine and HTTP app for the port."""
