"""Command-line entry points: inference and test."""
