"""Seeded worlds on disk in the dataset layout the port reads."""
