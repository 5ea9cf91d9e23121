"""Ingest: host decode (PIL) and the device image pipeline."""
