"""Ingest: host decode (the native C++ library or PIL) and the device image
pipeline."""
