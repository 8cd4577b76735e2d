"""Partitioned model tables."""
