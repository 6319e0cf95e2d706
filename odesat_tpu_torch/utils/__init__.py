"""Shared utilities: configuration, instance generation, logging, timing."""
