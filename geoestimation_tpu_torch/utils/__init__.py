"""Configuration (the hparams.yaml schema)."""
