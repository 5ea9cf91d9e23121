"""Configuration (the hparams.yaml schema), metrics logging and the spans
at the layer boundaries."""
