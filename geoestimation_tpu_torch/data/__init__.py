"""Eval image folders and meta CSVs."""
