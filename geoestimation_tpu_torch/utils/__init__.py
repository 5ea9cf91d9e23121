"""Configuration (the hparams.yaml schema) and metrics logging."""
